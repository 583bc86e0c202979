"""The program's own spans and counters (`repro_torch.trace`) over a
traced run's window: the per-layer numbers they give, and the device's
idle time split by the program's innermost span.

The records are a `repro_torch.trace.Records` snapshot (a table of spans
on `time.perf_counter_ns`, the clock of the run's window and request
stamps); the idle split reads the profiler's events (`harness.trace.Event`,
microseconds on the profiler's clock), where each span of the program is
a ``vita.*`` range.  Everything here is arithmetic over those two, so it
is tested on the CPU with made-up spans and events.

=============================  ===========================================
number                         what it reads
=============================  ===========================================
`stage_host_ms`                mean ``vita.server.stage`` over the
                               window's micro-batches
`forward_host_ms`              mean ``vita.server.forward``
`launch_host_us`               the forward spans' launch ns over their
                               launches
`host_wait_pct`                summed ``vita.server.wait`` in the window
                               over the window
`queue_in_wait_pct`            the part of each request's queue delay
                               that overlaps a ``vita.server.wait``,
                               summed, over the summed queue delay
`gc_pause_ms`                  summed ``vita.host.gc`` inside the window
`covered_pct`                  the union of the serving thread's spans
                               over the window
`idle_split`                   device idle time by innermost ``vita.*``
                               range, and "outside the program"
=============================  ===========================================
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from harness.trace import WINDOW, Event, clip, union

OUTSIDE = "outside the program"
PREFIX = "vita."


def _spans(records, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, start ns, end ns) of the closed spans named ``name``."""
    rows = records.rows(name)
    start = records.column("start")[rows]
    end = records.column("end")[rows]
    done = end > 0
    return rows[done], start[done], end[done]


def _ns(t_s: float) -> int:
    return int(round(t_s * 1e9))


def _starting_in(records, name: str, t_open: float, t_close: float):
    rows, start, end = _spans(records, name)
    keep = (start >= _ns(t_open)) & (start <= _ns(t_close))
    return rows[keep], start[keep], end[keep]


def _clipped_ns(start, end, lo: int, hi: int) -> int:
    return int(np.clip(np.minimum(end, hi) - np.maximum(start, lo), 0,
                       None).sum())


def mean_ms(records, name: str, t_open: float,
            t_close: float) -> Optional[float]:
    """Mean duration (ms) of the spans named ``name`` that start inside
    the window; None where there are none."""
    _, start, end = _starting_in(records, name, t_open, t_close)
    if len(start) == 0:
        return None
    return float((end - start).mean()) / 1e6


def stage_host_ms(records, t_open, t_close) -> Optional[float]:
    return mean_ms(records, "vita.server.stage", t_open, t_close)


def forward_host_ms(records, t_open, t_close) -> Optional[float]:
    return mean_ms(records, "vita.server.forward", t_open, t_close)


def launch_host_us(records, t_open, t_close) -> Optional[float]:
    """Host time a launch: the launch ns the window's forward spans
    counted over their launches; None where they launched nothing."""
    rows, _, _ = _starting_in(records, "vita.server.forward", t_open,
                              t_close)
    launches = int(records.column("a0")[rows].sum())
    if launches == 0:
        return None
    return float(records.column("a1")[rows].sum()) / launches / 1e3


def summed_ms(records, name: str, t_open: float, t_close: float) -> float:
    """The spans named ``name``, clipped to the window, summed (ms)."""
    _, start, end = _spans(records, name)
    return _clipped_ns(start, end, _ns(t_open), _ns(t_close)) / 1e6


def host_wait_pct(records, t_open, t_close) -> Optional[float]:
    if len(_spans(records, "vita.server.wait")[0]) == 0:
        return None
    return 100.0 * summed_ms(records, "vita.server.wait", t_open, t_close) \
        / ((t_close - t_open) * 1e3)


def gc_pause_ms(records, t_open, t_close) -> float:
    return summed_ms(records, "vita.host.gc", t_open, t_close)


def _covered(intervals: Sequence[Tuple[int, int]], a: np.ndarray,
             b: np.ndarray) -> np.ndarray:
    """For each [a_i, b_i], the length the union of ``intervals`` covers
    in it."""
    merged = union(intervals)
    if not merged:
        return np.zeros(len(a))
    s = np.array([x for x, _ in merged], np.float64)
    e = np.array([y for _, y in merged], np.float64)
    cum = np.concatenate([[0.0], np.cumsum(e - s)])

    def upto(t):
        i = np.searchsorted(s, t, side="right") - 1    # last one begun
        k = np.maximum(i, 0)
        return np.where(i >= 0, cum[k] + np.clip(t - s[k], 0, e[k] - s[k]),
                        0.0)
    return upto(np.asarray(b, np.float64)) - upto(np.asarray(a, np.float64))


def queue_in_wait_pct(records, requests,
                      name: str = "vita.server.wait") -> Optional[float]:
    """Over ``requests`` (``t_due``, ``t_start`` in s): the part of each
    one's queue delay during which the host was blocked on the card
    (inside a ``vita.server.wait``; or inside the spans ``name``), summed,
    over the summed delay."""
    if not requests:
        return None
    _, start, end = _spans(records, name)
    if len(start) == 0:
        return None
    a = np.array([r.t_due for r in requests]) * 1e9
    b = np.array([r.t_start for r in requests]) * 1e9
    queued = np.clip(b - a, 0, None).sum()
    if queued <= 0:
        return None
    inside = _covered(list(zip(start.tolist(), end.tolist())), a,
                      np.maximum(a, b)).sum()
    return 100.0 * float(inside) / float(queued)


def covered_pct(records, t_open, t_close,
                tid: Optional[int] = None) -> Optional[float]:
    """The union of the spans on thread ``tid`` (default: the thread that
    dispatched) inside the window, over the window."""
    rows, _, _ = _spans(records, "vita.server.dispatch")
    if len(rows) == 0:
        return None
    tids = records.column("tid")
    tid = int(tids[rows[0]]) if tid is None else tid
    start, end = records.column("start"), records.column("end")
    mine = (tids == tid) & (end > 0)
    lo, hi = _ns(t_open), _ns(t_close)
    ivs = clip(list(zip(start[mine].tolist(), end[mine].tolist())), lo, hi)
    return 100.0 * sum(e - s for s, e in union(ivs)) / (hi - lo)


def dispatch_parts_ms(records, t_open,
                      t_close) -> Optional[Dict[str, float]]:
    """Per micro-batch dispatched in the window: the mean of the dispatch
    span and of its stage, copy and forward children (ms), and their sum
    (``inside``)."""
    rows, start, end = _starting_in(records, "vita.server.dispatch", t_open,
                                    t_close)
    if len(rows) == 0:
        return None
    out = {"dispatch": float((end - start).mean()) / 1e6}
    parent = records.column("parent")
    for part in ("stage", "copy", "forward"):
        r, s, e = _spans(records, f"vita.server.{part}")
        mine = np.isin(parent[r], rows)
        out[part] = float((e[mine] - s[mine]).sum()) / len(rows) / 1e6
    out["inside"] = out["stage"] + out["copy"] + out["forward"]
    return out


def by_name(records, t_open, t_close) -> Dict[str, Tuple[int, float]]:
    """{span name: (spans starting in the window, their summed ms)}."""
    names = records.column("name")
    start, end = records.column("start"), records.column("end")
    keep = (start >= _ns(t_open)) & (start <= _ns(t_close)) & (end > 0)
    out: Dict[str, Tuple[int, float]] = {}
    for nid in np.unique(names[keep]):
        m = keep & (names == nid)
        out[records.names[nid]] = (int(m.sum()),
                                   float((end[m] - start[m]).sum()) / 1e6)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def _innermost(ranges: Sequence[Event], lo: float, hi: float
               ) -> List[Tuple[float, float, Optional[str]]]:
    """[lo, hi] cut into segments labelled by the innermost of the nested
    ``ranges`` covering them (None: no range)."""
    segs: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Event] = []
    cur = lo

    def emit(to: float, label: Optional[str]) -> None:
        nonlocal cur
        a, b = max(cur, lo), min(to, hi)
        if b > a:
            segs.append((a, b, label))
        cur = max(cur, to)

    for r in sorted(ranges, key=lambda e: (e.start, -e.end)):
        while stack and stack[-1].end <= r.start:
            top = stack.pop()
            emit(top.end, top.name)
        emit(r.start, stack[-1].name if stack else None)
        stack.append(r)
    while stack:
        top = stack.pop()
        emit(top.end, top.name)
    emit(hi, None)
    return segs


def idle_split(events: Sequence[Event]) -> List[Tuple[str, float]]:
    """The device's idle time inside the window (no kernel, copy or set)
    by the innermost ``vita.*`` range on the window's thread at each
    instant, and `OUTSIDE` where none was open: (label, seconds), the
    longest first."""
    windows = [e for e in events if e.kind == "host" and e.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(windows)}")
    win = windows[0]
    lo, hi = win.start, win.end
    busy = union(clip([(e.start, e.end) for e in events
                       if e.kind == "device"], lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ranges = [e for e in events if e.kind == "host" and e.tid == win.tid
              and e.name.startswith(PREFIX)]
    segs = _innermost(ranges, lo, hi)
    split: Dict[str, float] = collections.defaultdict(float)
    i = 0
    for a, b, label in segs:
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < b:
            s, e = max(a, idle[j][0]), min(b, idle[j][1])
            if e > s:
                split[label or OUTSIDE] += (e - s) / 1e6
            j += 1
    return sorted(split.items(), key=lambda kv: -kv[1])
