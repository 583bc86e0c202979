"""Window arithmetic: what a run's end-to-end numbers are made of.

A rate is every image completed inside the window over the window's whole
length; a tail is a percentile over every request of the window, by
numpy's linear interpolation (as the program's `stream_summary`).  No
number is a median of chunks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One served request: its bank image, when it was due (an open loop's
    schedule, or a closed-loop caller's resubmit), when its micro-batch
    was dispatched, when it completed, and the logits it got."""
    rid: int
    image: int
    t_due: float
    t_start: float
    t_done: float
    logits: Optional[Any] = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_due

    @property
    def queue_s(self) -> float:
        return self.t_start - self.t_due

    @property
    def service_s(self) -> float:
        return self.t_done - self.t_start


def completed_in(reqs: Sequence[Request], t_open: float,
                 t_close: float) -> List[Request]:
    """Requests that completed inside [t_open, t_close]."""
    return [r for r in reqs if t_open <= r.t_done <= t_close]


def due_in(reqs: Sequence[Request], t_open: float,
           t_close: float) -> List[Request]:
    """Requests due inside [t_open, t_close) (an open loop's window: the
    ones still queued when arrivals stop are drained and count)."""
    return [r for r in reqs if t_open <= r.t_due < t_close]


def rate(reqs: Sequence[Request], t_open: float, t_close: float) -> float:
    """Images completed inside the window over its length (1/s)."""
    return len(completed_in(reqs, t_open, t_close)) / (t_close - t_open)


def percentile_ms(values_s: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear interpolation) of ``values_s``, in
    ms; None for no values."""
    if len(values_s) == 0:
        return None
    return float(np.percentile(np.asarray(values_s, np.float64) * 1e3, q))
