"""The comparison that decides ``correct``.

Every request the run served is compared with the plain reference's
logits for its image: requests draw their images from a seeded bank, so
the reference runs once over the bank and every served answer, whatever
its bucket, batch position or padding, has its reference row.

The number compared is ``logit_gap``: over the served requests, the
largest ``max_k |served_k - ref_k| / max_k |ref_k|``, each request's worst
logit error against its reference's logit scale.  A missing or non-finite
answer reads as infinity.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from harness.window import Request


def row_gaps(served: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per row of (n, C) logits: max |served - ref| / max |ref|."""
    served = np.asarray(served, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=1)
    gap = np.abs(served - ref).max(axis=1) / np.maximum(scale, 1e-30)
    gap[~np.isfinite(gap)] = math.inf
    return gap


def logit_gap(reqs: Sequence[Request], ref: np.ndarray
              ) -> Tuple[float, Optional[int]]:
    """(the largest gap over ``reqs``, the rid where it is) against
    ``ref`` (bank size, C): reference logits indexed by bank image."""
    if not reqs:
        return math.inf, None
    served = np.stack([np.asarray(r.logits, np.float64)
                       if r.logits is not None
                       else np.full(ref.shape[1], np.nan) for r in reqs])
    gaps = row_gaps(served, ref[[r.image for r in reqs]])
    worst = int(np.argmax(gaps))
    return float(gaps[worst]), reqs[worst].rid


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> bool:
    """Correct when no request failed and every number is within its
    limit."""
    return failed == 0 and all(numbers[k] <= limits[k] for k in limits)
