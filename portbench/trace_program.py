#!/usr/bin/env python3
"""A traced run of one cell with the program's own tracer on: the spans
and counters of `repro_torch.trace` read over the window.

    python3 portbench/trace_program.py --workload deit_s.fp32.backlog \\
        --seed 7 --seconds 30

It is `run.py --trace 1` (the same `run.run_cell`, profiler, window,
correctness check and result line) with `repro_torch.trace` enabled from
the profiler's start to its stop, and one more key in the printed JSON
line, ``program``: the numbers of `harness.program_trace` (stage, forward
and launch host time, the host's wait on the card, the queue delay spent
in that wait, the collector's pauses, the spans' cover of the serving
thread), the dispatch split into its parts beside the benchmark's own
outside span, spans by name, the tracer's counters and the device's idle
time split by the innermost program span.  Besides, in both modes, a
collector hook of its own times every collection in the window
(``gc_timed_ms``), so ``--program-tracer 0`` (the tracer left off) shows
what the collector costs without the tracer's records.  The benchmark's
runs never call it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import run as bench_run  # noqa: E402
from harness import program_trace as pt  # noqa: E402
from harness import spec  # noqa: E402
from harness import trace as bench_trace  # noqa: E402


class GcTimer:
    """Every collection's (start, end) on `time.perf_counter`."""

    def __init__(self):
        self.spans, self._t = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.spans.append((self._t, time.perf_counter()))
            self._t = None

    def in_window(self, t_open, t_close):
        """(collections that ran inside the window, their ms there)."""
        inside = [min(e, t_close) - max(s, t_open) for s, e in self.spans]
        return (sum(1 for d in inside if d > 0),
                1e3 * sum(d for d in inside if d > 0))


def program_numbers(records, counters, run, split):
    t_open, t_close = run.t_open, run.t_close
    parts = pt.dispatch_parts_ms(records, t_open, t_close)
    outside = (sum(run.dispatch_ms) / len(run.dispatch_ms)
               if run.dispatch_ms else None)
    return {
        "stage_host_ms": pt.stage_host_ms(records, t_open, t_close),
        "forward_host_ms": pt.forward_host_ms(records, t_open, t_close),
        "launch_host_us": pt.launch_host_us(records, t_open, t_close),
        "host_wait_pct": pt.host_wait_pct(records, t_open, t_close),
        "queue_in_wait_pct": pt.queue_in_wait_pct(records, run.requests),
        "queue_in_complete_pct": pt.queue_in_wait_pct(
            records, run.requests, "vita.server.complete"),
        "gc_pause_ms": pt.gc_pause_ms(records, t_open, t_close),
        "covered_pct": pt.covered_pct(records, t_open, t_close),
        "dispatch_parts_ms": parts,
        "dispatch_outside_ms": outside,
        "by_name": pt.by_name(records, t_open, t_close),
        "counters": counters,
        "idle_split_s": split,
    }


def main(argv=None) -> int:
    t_start = bench_run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from repro_torch import trace as tracer

    cell = spec.load_cell(args.workload)
    seen = {}
    install, from_profiler = bench_trace.Spans.install, \
        bench_trace.from_profiler

    def install_and_enable(self):
        install(self)
        if args.program_tracer:
            tracer.reset()
            tracer.enable()

    def read_and_disable(prof):
        events = from_profiler(prof)
        seen["records"], seen["counters"] = tracer.records(), \
            tracer.counters()
        tracer.disable()
        t = time.perf_counter()
        seen["split"] = pt.idle_split(events)
        bench_run.log(f"idle split in {time.perf_counter() - t:.1f} s")
        return events

    gc_timer = GcTimer()
    gc.callbacks.append(gc_timer)
    bench_trace.Spans.install = install_and_enable
    bench_trace.from_profiler = read_and_disable
    try:
        result, compared, run = bench_run.run_cell(
            cell, args.seed, args.seconds, True, "cuda", t_start)
    finally:
        bench_trace.Spans.install = install
        bench_trace.from_profiler = from_profiler
        gc.callbacks.remove(gc_timer)
        tracer.disable()
    line = bench_run.result_line(result, compared)
    line["program"] = (program_numbers(seen["records"], seen["counters"],
                                       run, seen["split"])
                       if args.program_tracer else {})
    line["program"]["gc_collections"], line["program"]["gc_timed_ms"] = \
        gc_timer.in_window(run.t_open, run.t_close)
    line["program"]["tracer"] = args.program_tracer
    print(json.dumps(line), flush=True)
    bench_run.log(f"correct {result['correct']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
