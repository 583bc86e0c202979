"""The port's tracer: spans and counters inside the serving path.

Off by default: an instrumented site then costs one check of the
module-level flag `ON` (no clock read, no allocation, no profiler range).
`enable` and `disable` are the whole switch; there is no environment
variable and no flag.

While it is on:

* every `span` records its name, its start and end on
  `time.perf_counter_ns` (the clock of `VisionRequest`'s stamps), the id
  of its parent (a per-thread stack), a ``batch`` id (a micro-batch's
  dispatch span's own id, inherited by the spans under it) and two integer
  attributes ``a0``, ``a1``;
* the records go into one preallocated int64 table (names interned), so
  they do not feed the collector; the table holds ``cap`` spans and
  counts the rest as ``dropped``;
* while a `torch.profiler` records, each span also enters a profiler
  range of its name (a host-side record function, the one-microsecond
  kind `torch.compile` uses, where `torch.profiler.record_function` costs
  ten), so the span sits on the device trace's own clock and names the
  idle gaps there; `to_trace_clock` places the in-memory
  records there (the profiler's stamps are epoch nanoseconds), from the
  (perf_counter_ns, time_ns) pairs taken at `enable` and `disable`;
* a `gc.callbacks` hook records every collection as a ``vita.host.gc``
  span (``a0``: its generation);
* `count` adds to named integer counters.  The module that knows a
  quantity declares its counter (`counter`, at import, so it reads 0
  until counted) and counts it behind its own check of `ON`; the tracer
  knows none of them.  `launch_span` reads the two that
  `kernels.build.call` counts under.

Spans of the serving path (``a0`` / ``a1`` where they carry something):

================================  ==========================================
``vita.admission.submit``         `AdmissionController.submit`; a0 the rid
``vita.admission.step``           `AdmissionController.step`, whole
``vita.admission.assemble``       its pick of the next group; a0 1 when it
                                  held a partial bucket back
``vita.server.dispatch``          `VisionServer.dispatch`; its id is the
                                  micro-batch's ``batch``; a0 the bucket,
                                  a1 the requests
``vita.server.stage``             the pinned staging; a0 bytes staged
``vita.server.copy``              the host-to-device copy's enqueue
``vita.server.forward``           the forward; a0 launches, a1 launch ns
                                  through `build.call` inside it
``vita.phase.<kind>``             each phase of `core.schedule.run_schedule`;
                                  a0 its index
``vita.kernels.vita_layer``       `ops.vita_layer_fused` / `vita_layer_int8`
                                  on x (B', N, D); a0 N, the tokens a
                                  sequence (TNT: the pixel tokens of a
                                  patch on the inner stream), a1 B', the
                                  sequences (images x windows or patches)
``vita.kernels.build``            `build.library` building or loading a
                                  library; a0 its index in `LIBRARIES`
``vita.server.complete``          `VisionServer.complete`, whole
``vita.server.wait``              the host blocked on the event behind the
                                  micro-batch's logits copy; a0 1 when that
                                  event had not completed yet (0 on the CPU
                                  and on a mesh)
``vita.server.readback``          logits to the host, stamps, argmax; a0 1
                                  when they came through the pinned copy
                                  queued at dispatch (0 on the CPU and on a
                                  mesh: read back synchronously)
``vita.host.gc``                  a collection; a0 its generation
================================  ==========================================

`records` and `counters` are snapshots, `reset` clears both.  `mark` and
`rewind` take back what a stretch of work recorded (the admission layer's
latency probes).
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

ON = False
CAP = 1_000_000            # spans the table holds
OWN = -2                   # ``batch``: the span's own id (a dispatch)
FIELDS = ("name", "start", "end", "parent", "batch", "tid", "a0", "a1")
_W = len(FIELDS)
_NAME, _START, _END, _PARENT, _BATCH, _TID, _A0, _A1 = range(_W)


class _State:
    def __init__(self):
        # Reentrant: a call inside a region that holds it may run a
        # pending collection, whose ``vita.host.gc`` span takes it again.
        self.lock = threading.RLock()
        self.names: List[str] = []
        self.ids: Dict[str, int] = {}
        self.table: Optional[np.ndarray] = None
        self.cells = None            # the table as a flat int64 memoryview
        self.cap = 0
        self.n = 0                   # spans begun (stored or dropped)
        self.counts: Dict[str, int] = {}  # in order of declaration
        self.anchors: List[Tuple[int, int]] = []
        self.gc_open: List["_Span"] = []


_S = _State()
_tls = threading.local()


def _stack() -> List["_Span"]:
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        _tls.tid = threading.get_native_id()
        return _tls.stack


def _name_id(name: str) -> int:
    nid = _S.ids.get(name)
    if nid is None:
        with _S.lock:
            nid = _S.ids.setdefault(name, len(_S.names))
            if nid == len(_S.names):
                _S.names.append(name)
    return nid


class _Span:
    """One span while it is open (`span` hands it out when tracing is on)."""

    __slots__ = ("name", "batch", "a0", "a1", "slot", "rf")

    def __init__(self, name: str, batch: int, a0: int, a1: int):
        self.name, self.batch, self.a0, self.a1 = name, batch, a0, a1
        self.slot = -1
        self.rf = None

    @property
    def id(self) -> int:
        """The span's row in the table (-1: dropped by the cap)."""
        return self.slot

    def set(self, a0: Optional[int] = None, a1: Optional[int] = None):
        if a0 is not None:
            self.a0 = a0
        if a1 is not None:
            self.a1 = a1

    def __enter__(self) -> "_Span":
        s = _S
        stack = _stack()
        parent = stack[-1] if stack else None
        with s.lock:
            slot = s.n
            s.n += 1
        self.slot = slot if slot < s.cap else -1
        if self.batch == OWN:
            self.batch = self.slot
        elif self.batch < 0 and parent is not None:
            self.batch = parent.batch
        stack.append(self)
        if self.slot >= 0:
            i = self.slot * _W
            c = s.cells
            c[i + _NAME] = _name_id(self.name)
            c[i + _PARENT] = -1 if parent is None else parent.slot
            c[i + _BATCH] = self.batch
            c[i + _TID] = _tls.tid
            c[i + _END] = 0
            c[i + _START] = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, et, ev, tb) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if self.slot >= 0:
            i = self.slot * _W
            c = _S.cells
            c[i + _END] = time.perf_counter_ns()
            c[i + _A0] = self.a0
            c[i + _A1] = self.a1
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)


# The counters `kernels.build.call` counts launches under (`launch_span`).
_LAUNCHES, _LAUNCH_NS = "kernels.launches", "kernels.launch_ns"


class _LaunchSpan(_Span):
    """A span whose a0 / a1 are the launches and launch ns counted inside
    it."""

    __slots__ = ()

    def __enter__(self) -> "_LaunchSpan":
        c = _S.counts
        self.a0, self.a1 = c.get(_LAUNCHES, 0), c.get(_LAUNCH_NS, 0)
        return super().__enter__()

    def __exit__(self, et, ev, tb) -> None:
        c = _S.counts
        self.a0 = c.get(_LAUNCHES, 0) - self.a0
        self.a1 = c.get(_LAUNCH_NS, 0) - self.a1
        super().__exit__(et, ev, tb)


class _Off:
    """What `span` hands out when tracing is off: enters nothing."""

    __slots__ = ()
    id = -1

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, et, ev, tb) -> None:
        return None

    def set(self, a0: Optional[int] = None, a1: Optional[int] = None):
        return None


_OFF = _Off()


def span(name: str, batch: int = -1, a0: int = 0, a1: int = 0):
    """A context manager recording one span named ``name`` (module
    docstring).  ``batch`` -1 inherits the parent's, `OWN` takes the
    span's own id.  Off: a shared object that records nothing."""
    if not ON:
        return _OFF
    return _Span(name, batch, a0, a1)


def launch_span(name: str, batch: int = -1):
    """`span` whose a0 / a1 are the kernel launches and their host ns
    counted by `kernels.build.call` inside it."""
    if not ON:
        return _OFF
    return _LaunchSpan(name, batch, 0, 0)


def counter(name: str) -> str:
    """Declare the counter ``name`` (it reads 0 until counted; declaring
    it again changes nothing) and return the name, for `count`."""
    with _S.lock:
        _S.counts.setdefault(name, 0)
    return name


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the declared counter ``name``; nothing while tracing
    is off."""
    if ON:
        with _S.lock:
            _S.counts[name] += n


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        if ON:
            sp = _Span("vita.host.gc", -1, int(info["generation"]), 0)
            sp.__enter__()
            _S.gc_open.append(sp)
    elif _S.gc_open:
        _S.gc_open.pop().__exit__(None, None, None)


def _anchor() -> Tuple[int, int]:
    """(perf_counter_ns, time_ns) read at one moment (the perf stamp is
    the midpoint of two around the epoch read)."""
    p0 = time.perf_counter_ns()
    w = time.time_ns()
    p1 = time.perf_counter_ns()
    return (p0 + p1) // 2, w


def enable(cap: int = CAP) -> None:
    """Turn tracing on, into a table of ``cap`` spans (a new table, and a
    `reset`, when the cap differs from the current one)."""
    global ON
    if _S.table is None or _S.cap != cap:
        _S.table = np.zeros((cap, _W), np.int64)
        _S.cells = memoryview(_S.table).cast("B").cast("q")
        _S.cap = cap
        reset()
    _S.anchors.append(_anchor())
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    ON = True


def disable() -> None:
    """Turn tracing off and remove the collector hook; the records stay
    until `reset`."""
    global ON
    ON = False
    while _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    while _S.gc_open:
        _S.gc_open.pop().__exit__(None, None, None)
    if _S.table is not None:
        _S.anchors.append(_anchor())


def reset() -> None:
    """Drop every record and zero the counters."""
    with _S.lock:
        _S.n = 0
        _S.counts = dict.fromkeys(_S.counts, 0)
    _S.anchors = [_anchor()] if ON else []


def mark() -> Tuple[int, Dict[str, int]]:
    """Where the records and counters stand (for `rewind`)."""
    with _S.lock:
        return _S.n, dict(_S.counts)


def rewind(at: Tuple[int, Dict[str, int]]) -> None:
    """Take back every span begun and everything counted since `mark`
    returned ``at`` (no span begun since may still be open)."""
    with _S.lock:
        _S.n, counts = at
        _S.counts = {name: counts.get(name, 0) for name in _S.counts}


def counters() -> Dict[str, int]:
    """A snapshot: every declared counter, in order of declaration, then
    ``spans`` stored and ``dropped`` by the cap."""
    with _S.lock:
        n, counts = _S.n, dict(_S.counts)
    return {**counts, "spans": min(n, _S.cap), "dropped": max(n - _S.cap, 0)}


class Span(NamedTuple):
    """One record; ``end`` None while the span is open."""
    id: int
    name: str
    start: int
    end: Optional[int]
    parent: int
    batch: int
    tid: int
    a0: int
    a1: int


@dataclasses.dataclass(frozen=True)
class Records:
    """A snapshot of the table: ``table`` (spans x `FIELDS`, int64; a
    span's id is its row) and the interned ``names``."""
    names: Tuple[str, ...]
    table: np.ndarray

    def __len__(self) -> int:
        return len(self.table)

    def column(self, field: str) -> np.ndarray:
        return self.table[:, FIELDS.index(field)]

    def rows(self, name: str) -> np.ndarray:
        """The ids of the spans named ``name``, in start order of
        recording."""
        if name not in self.names:
            return np.zeros(0, np.int64)
        return np.flatnonzero(self.column("name") == self.names.index(name))

    def spans(self) -> List[Span]:
        return [Span(i, self.names[r[_NAME]], int(r[_START]),
                     int(r[_END]) or None, *(int(v) for v in r[_PARENT:]))
                for i, r in enumerate(self.table)]


def records() -> Records:
    """A copy of every stored span."""
    with _S.lock:
        n = min(_S.n, _S.cap)
    table = (_S.table[:n].copy() if _S.table is not None
             else np.zeros((0, _W), np.int64))
    return Records(tuple(_S.names), table)


def to_trace_clock(ns):
    """``time.perf_counter_ns`` stamps (an int or an array) on the
    profiler's clock (epoch ns): the offset between the clocks
    interpolated between the anchors `enable` and `disable` took, or read
    now where there are none."""
    anchors = _S.anchors or [_anchor()]
    perf = np.array([p for p, _ in anchors], np.float64)
    off = np.array([w - p for p, w in anchors], np.int64)
    base = int(off[0])
    delta = np.interp(np.asarray(ns, np.float64), perf,
                      (off - base).astype(np.float64))
    out = np.asarray(ns, np.int64) + base + np.rint(delta).astype(np.int64)
    return int(out) if out.ndim == 0 else out
