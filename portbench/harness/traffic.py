"""The one traffic generator: every traffic mix is a file of parameters it
reads (``traffic/<name>.json``).

Parameters:

* ``loop``: ``"closed"`` (``clients`` callers; each completion resubmits
  at once) or ``"open"`` (arrivals on a schedule, whatever completes);
* ``clients`` (closed): requests outstanding at every moment;
* ``rate_img_s`` (open): mean offered images a second;
* ``sla_ms``: each request's latency budget, or null;
* ``buckets``: the server's batch buckets;
* ``latency_probes`` (default 2, the controller's own): timed round trips
  per bucket when the controller measures its bucket latencies at
  set-up; it keeps the fastest, and its SLA bucket choice reads them;
* ``bank``: the number of seeded images requests draw from;
* ``warmup_s``: seconds of the same traffic before the window opens
  (set-up; an open loop is drained before the window).

`drive_closed` and `drive_open` take any controller with the admission
layer's interface (``submit``, ``step``, ``drain``, ``pending``,
``in_flight``, ``ring``) and a clock, so the window arithmetic can be
tested with a fake one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import numpy as np

from harness.window import Request

KEYS = {"loop", "clients", "rate_img_s", "sla_ms", "buckets",
        "latency_probes", "bank", "warmup_s", "why"}


@dataclasses.dataclass(frozen=True)
class Traffic:
    loop: str
    buckets: Tuple[int, ...]
    bank: int
    warmup_s: float
    sla_ms: Optional[float] = None
    clients: int = 0
    rate_img_s: float = 0.0
    latency_probes: int = 2


def parse(params: Mapping[str, Any]) -> Traffic:
    unknown = set(params) - KEYS
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    loop = params["loop"]
    if loop == "closed":
        if int(params.get("clients", 0)) < 1:
            raise ValueError("a closed loop needs clients >= 1")
    elif loop == "open":
        if float(params.get("rate_img_s", 0)) <= 0:
            raise ValueError("an open loop needs rate_img_s > 0")
    else:
        raise ValueError(f"loop must be 'closed' or 'open', got {loop!r}")
    return Traffic(loop=loop, buckets=tuple(int(b) for b in params["buckets"]),
                   bank=int(params["bank"]),
                   warmup_s=float(params.get("warmup_s", 0.0)),
                   sla_ms=params.get("sla_ms"),
                   clients=int(params.get("clients", 0)),
                   rate_img_s=float(params.get("rate_img_s", 0.0)),
                   latency_probes=int(params.get("latency_probes", 2)))


def image_order(seed: int, bank: int, n: int = 1 << 16) -> np.ndarray:
    """The sequence of bank indices requests take in turn: seeded
    permutations of the bank, one after another, so every image is sent
    equally often."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    reps = -(-n // bank)
    return np.concatenate([rng.permutation(bank) for _ in range(reps)])[:n]


def arrivals(traffic: Traffic, seed: int, seconds: float,
             stream: int = 2) -> np.ndarray:
    """Open loop: the due times (s from the stream's start, sorted) of
    the images offered in ``[0, seconds)``: ``round(rate_img_s *
    seconds)`` of them, each uniform over the stream, which is a Poisson
    process at ``rate_img_s`` given its count.  Every seed offers the same
    number of images, at other times; ``stream`` picks one of the seed's
    independent draws (the window's, or the warm-up's)."""
    n = int(round(traffic.rate_img_s * seconds))
    rng = np.random.default_rng([int(seed) % (2 ** 63), stream])
    return np.sort(rng.uniform(0.0, seconds, size=n))


class Feed:
    """Submits requests to a controller and keeps them: each takes the next
    image of ``order`` and records its bank index."""

    def __init__(self, ctl, model: str, images: Sequence[Any],
                 order: np.ndarray, sla_ms: Optional[float]):
        self.ctl, self.model, self.images = ctl, model, images
        self.order, self.sla_ms = order, sla_ms
        self.k = 0
        self.sent: List[Tuple[Any, int]] = []

    def submit(self, t_due: float) -> None:
        idx = int(self.order[self.k % len(self.order)])
        self.k += 1
        req = self.ctl.submit(self.model, self.images[idx],
                              sla_ms=self.sla_ms, t_submit=t_due)
        self.sent.append((req, idx))

    def requests(self, since: int = 0) -> List[Request]:
        """The completed requests sent from index ``since`` on, as
        `window.Request`\\ s."""
        out = []
        for req, idx in self.sent[since:]:
            if req.t_done is None:
                continue
            out.append(Request(rid=req.rid, image=idx, t_due=req.t_submit,
                               t_start=req.t_start, t_done=req.t_done,
                               logits=getattr(req, "logits", None)))
        return out


def drive_closed(feed: Feed, clients: int, warmup_s: float, seconds: float,
                 clock: Callable[[], float] = time.perf_counter,
                 marks=None) -> Tuple[float, float]:
    """Run ``clients`` closed-loop callers for ``warmup_s`` and then a
    window of ``seconds``; stop resubmitting when the window closes and
    drain.  Returns the window (t_open, t_close) on ``clock``; ``marks``
    (``open()``, ``close()``) is told when the window opens and closes."""
    ctl = feed.ctl
    while ctl.pending + ctl.in_flight < clients:
        feed.submit(clock())
    t_open = clock() + warmup_s
    while clock() < t_open:
        for _ in range(ctl.step()):
            feed.submit(clock())
    if marks is not None:
        marks.open()
    t_open = clock()
    t_close = t_open + seconds
    while clock() < t_close:
        for _ in range(ctl.step()):
            feed.submit(clock())
    if marks is not None:
        marks.close()
    ctl.drain()
    return t_open, t_close


def drive_open(feed: Feed, due: np.ndarray,
               clock: Callable[[], float] = time.perf_counter,
               sleep: Callable[[float], None] = time.sleep
               ) -> Tuple[float, List[float]]:
    """Replay the due times ``due`` (s from now) through the controller in
    real time, each request stamped at its due time, then drain.  Returns
    the stream's start on ``clock`` and how late each submit ran (s)."""
    ctl = feed.ctl
    t0 = clock()
    late: List[float] = []
    i, n = 0, len(due)
    while i < n or ctl.pending or ctl.ring:
        now = clock() - t0
        while i < n and due[i] <= now:
            feed.submit(t0 + float(due[i]))
            late.append(now - float(due[i]))
            i += 1
        if ctl.pending or ctl.ring:
            ctl.step()
        elif i < n:
            sleep(min(max(float(due[i]) - now, 0.0), 0.005))
    return t0, late


def summarize_lateness(late: Sequence[float]) -> Dict[str, float]:
    if not late:
        return {"n": 0}
    a = np.asarray(late) * 1e3
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max())}
