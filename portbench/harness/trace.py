"""The traced run: `torch.profiler` over the window, the benchmark's own
spans around the program's calls, and the reduction of the device trace
to the per-layer numbers.

Spans (installed only in a traced run, by the benchmark, around the
program's own functions):

* ``portbench.vita_layer_fused``: a `record_function` range around each
  `ops.vita_layer_fused` call (kernel 1), with the call's shapes kept in
  order; the profiler puts a matching range on the device from the first
  kernel the call launched to the end of its last, so the kernels inside
  it are the call's (one stream);
* ``VisionServer.dispatch`` / ``VisionServer.complete``: ranges that name
  what the host was doing in a device gap; dispatch also gets a host-clock
  span (staging, the H2D copy's enqueue, the schedule's launches).

The reduction reads the profiler's events (kernels, copies and sets on
the device; ranges; host ops and runtime calls) as plain tuples, so it is
tested on the CPU with made-up events.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import inspect
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
LAYER = "portbench.vita_layer_fused"


@dataclasses.dataclass(frozen=True)
class Event:
    """One trace event, times in microseconds: ``kind`` is ``device`` (a
    kernel, copy or set), ``range`` (a range's device side), ``host`` (an
    op, runtime call or range on a host thread)."""
    kind: str
    name: str
    start: float
    end: float
    tid: int = 0


def from_profiler(prof) -> List[Event]:
    """The profiler's events as `Event`\\ s (kineto's own event list)."""
    from torch.autograd import DeviceType
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            kind = "range" if e.is_user_annotation() else "device"
        else:
            kind = "host"
        out.append(Event(kind, e.name(), start, end, e.start_thread_id()))
    return out


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """Merge overlapping intervals (sorted, disjoint)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    layer_device_s: List[float]          # per kernel-1 range in the window
    layer_calls: List[int]               # their indices among all calls

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _host_label(host: Sequence[Event], t: float) -> str:
    """What the main thread was doing at ``t``: the outermost benchmark
    range and the innermost op covering it."""
    around = [e for e in host if e.start <= t <= e.end]
    if not around:
        return "host: Python between profiled ops"
    inner = min(around, key=lambda e: e.end - e.start)
    outer = [e for e in around if e.name.startswith("VisionServer.")]
    if not outer:
        return inner.name
    if outer[0] is inner:
        return f"{inner.name} > Python, no torch op"
    return f"{outer[0].name} > {inner.name}"


def reduce(events: Sequence[Event], top: int = 10) -> Summary:
    """Per-layer numbers of the window: the union of device intervals
    inside it (busy), the operations that took most device time, the
    longest idle gaps labelled by the host's activity, and each kernel-1
    range's device time (the kernels that start inside it)."""
    windows = [e for e in events if e.kind == "host" and e.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} range, found {len(windows)}")
    win = windows[0]
    lo, hi = win.start, win.end
    device = sorted((e for e in events if e.kind == "device"),
                    key=lambda e: e.start)
    inside = clip([(e.start, e.end) for e in device], lo, hi)
    busy = union(inside)
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        s, t = max(e.start, lo), min(e.end, hi)
        if t > s:
            by_name[e.name] += t - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    host = [e for e in events if e.kind == "host" and e.tid == win.tid
            and e.name != WINDOW]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [(_host_label(host, (s + e) / 2), (e - s) / 1e6) for s, e in gaps]

    host_ranges = sorted((e for e in events
                          if e.kind == "host" and e.name == LAYER),
                         key=lambda e: e.start)
    dev_ranges = sorted((e for e in events
                         if e.kind == "range" and e.name == LAYER),
                        key=lambda e: e.start)
    layer_s: List[float] = []
    calls: List[int] = []
    if len(host_ranges) == len(dev_ranges):
        starts = [e.start for e in device]
        for i, (h, d) in enumerate(zip(host_ranges, dev_ranges)):
            if not lo <= h.start <= hi:
                continue
            j = bisect.bisect_left(starts, d.start - 1e-3)
            took = 0.0
            while j < len(device) and device[j].start <= d.end + 1e-3:
                took += device[j].end - device[j].start
                j += 1
            layer_s.append(took / 1e6)
            calls.append(i)
    return Summary(window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                   device_ops=[(n, t / 1e6) for n, t in ops],
                   idle_gaps=idle, layer_device_s=layer_s, layer_calls=calls)


class Spans:
    """The benchmark's spans around the program's calls (module
    docstring); `install` wraps, `remove` restores."""

    def __init__(self, ops_module, server):
        self.ops, self.server = ops_module, server
        self.layer_shapes: List[Tuple[Any, ...]] = []
        self.dispatch: List[Tuple[float, float]] = []   # host (start, end)
        # (host time the call returned, device ms of its micro-batch)
        self.completes: List[Tuple[float, Optional[float]]] = []
        self._saved: Dict[str, Any] = {}

    def install(self) -> None:
        import torch
        rf = torch.profiler.record_function
        ops, server = self.ops, self.server
        layer, dispatch, complete = (ops.vita_layer_fused, server.dispatch,
                                     server.complete)
        self._saved = {"layer": layer, "dispatch": dispatch,
                       "complete": complete}
        shapes = self.layer_shapes
        spans, completes = self.dispatch, self.completes
        sig = inspect.signature(layer)

        def vita_layer_fused(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            bias, mask = a.get("bias"), a.get("mask")
            shapes.append((tuple(a["x"].shape), a["wq"].shape[0],
                           a["wq"].shape[2], a["w_up"].shape[1],
                           0 if bias is None else bias.numel(),
                           0 if mask is None else mask.numel(),
                           a["x"].element_size()))
            with rf(LAYER):
                return layer(*args, **kw)

        def timed_dispatch(*args, **kw):
            with rf("VisionServer.dispatch"):
                t = time.perf_counter()
                out = dispatch(*args, **kw)
                spans.append((t, time.perf_counter()))
                return out

        def traced_complete(*args, **kw):
            with rf("VisionServer.complete"):
                n = len(server.device_ms)
                out = complete(*args, **kw)
                ms = server.device_ms[n] if len(server.device_ms) > n \
                    else None
                completes.append((time.perf_counter(), ms))
                return out

        ops.vita_layer_fused = vita_layer_fused
        server.dispatch = timed_dispatch
        server.complete = traced_complete

    def remove(self) -> None:
        if self._saved:
            self.ops.vita_layer_fused = self._saved["layer"]
            del self.server.dispatch
            del self.server.complete
            self._saved = {}


class Window:
    """A `record_function` range that `traffic.drive_closed` (``marks``)
    or the caller of `traffic.drive_open` opens and closes: it marks the
    measured window in the trace."""

    def __init__(self):
        import torch
        self._rf = torch.profiler.record_function(WINDOW)

    def open(self) -> None:
        self._rf.__enter__()

    def close(self) -> None:
        self._rf.__exit__(None, None, None)


def layer_roofline(summary: Summary, shapes: Sequence[Tuple[Any, ...]]
                   ) -> Optional[Tuple[float, float]]:
    """(least seconds, device seconds) of the kernel-1 calls inside the
    window, or None where the trace's ranges do not pair one to one with
    the calls the span recorded."""
    from harness.counts import least_time_s, vita_layer_call
    if not summary.layer_calls or len(shapes) < max(summary.layer_calls) + 1:
        return None
    least = 0.0
    for i in summary.layer_calls:
        x_shape, heads, dh, hidden, bias_n, mask_n, elem = shapes[i]
        ops, nbytes = vita_layer_call(x_shape, heads, dh, hidden, bias_n,
                                      mask_n, elem)
        least += least_time_s(ops, nbytes)
    return least, sum(summary.layer_device_s)
