#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload deit_s.fp32.backlog --seed 7 \\
        --seconds 15 --trace 0

A run loads the cell's configuration, traffic and metric files by name,
builds the configuration's CUDA libraries (once per checkout), makes the
weights and the image bank on the card from ``--seed``, builds the port's
`VisionServer` behind its `AdmissionController` and drives the cell's
traffic through ``submit`` / ``step``: a warm-up, then a window of
``--seconds``.  Once the window has closed it reads the memory peak,
frees the program, runs the plain reference over the image bank and
compares every served request's logits with it.  It prints each number
compared beside its limit as its last lines on standard error, and one
JSON line as the last line of standard output: ``--trace 0`` the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics read from
`torch.profiler` over the window and the benchmark's own spans.

It needs a CUDA device and exits non-zero without printing a result when
there is none, when the cell asks for more devices than there are, or
when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, guard, program, spec, trace  # noqa: E402
from harness import traffic as tr  # noqa: E402
from harness import window as win  # noqa: E402
from reference import common  # noqa: E402

REF_BLOCK = 16          # reference images per forward


def process_start() -> float:
    """When this process started, on `time.perf_counter`'s clock (Linux:
    from /proc; elsewhere the moment this module began importing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    setup_s: float
    t_open: float
    t_close: float
    requests: List[win.Request]          # the window's requests
    completed_in_window: int
    flops_per_image: float
    micro_batch_device_ms: Optional[List[float]] = None
    dispatch_ms: Optional[List[float]] = None
    summary: Optional[trace.Summary] = None
    layer_least_device_s: Optional[Tuple[float, float]] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def reference_logits(ref, config, seed: int, n_images: int,
                     device: str, mode: str = "fp32") -> np.ndarray:
    """The reference's logits for the seed's whole image bank, from the
    weights and images made again from the seed (nothing the program
    made), in blocks of `REF_BLOCK` images."""
    sizes = config["sizes"]
    params = common.make_tree(ref.leaves(sizes), seed, device)
    bank = common.images(seed, n_images, sizes["image"], device)
    out = []
    with torch.no_grad():
        for i in range(0, n_images, REF_BLOCK):
            out.append(ref.forward(params, bank[i:i + REF_BLOCK], sizes,
                                   mode).double().cpu().numpy())
    return np.concatenate(out)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: str, t_start: float
             ) -> Tuple[Dict[str, Any], Dict[str, Tuple[float, float]], Run]:
    """One run of ``cell``: (the result's fields, each number compared with
    its limit, what the metrics were read from)."""
    config = cell.config
    traffic = tr.parse(cell.traffic)
    ref = spec.load_reference(config["family"])
    sizes = config["sizes"]
    on_card = device == "cuda"
    if on_card:
        t = time.perf_counter()
        built = program.build_libraries(config["libraries"])
        log(f"libraries {config['libraries']}: "
            + ("built " + ", ".join(f"{k} ({v.splitlines()[0]})"
                                    for k, v in built.items())
               if built else "already built")
            + f" in {time.perf_counter() - t:.1f} s")

    t_made = time.perf_counter()
    params = common.make_tree(ref.leaves(sizes), seed, device)
    bank = common.images(seed, traffic.bank, sizes["image"], device)
    images = list(bank.cpu().numpy())
    del bank
    t_served = time.perf_counter()
    server, ctl = program.serve(config, traffic, params, device)
    log(f"set-up so far: {t_made - t_start:.2f} s start, imports and the "
        f"libraries, {t_served - t_made:.2f} s the card's context, weights "
        f"and images, {time.perf_counter() - t_served:.2f} s server and "
        f"controller; bucket latencies the controller measured (ms): "
        + json.dumps({str(b): round(v, 3) for b, v in
                      next(iter(ctl.lanes.values())).latencies.items()}))
    feed = tr.Feed(ctl, config["name"], images,
                   tr.image_order(seed, traffic.bank), traffic.sla_ms)
    # The set-up's objects (torch's own among them) leave the collector's
    # reach: on the H100 machine a full collection over them stalled the
    # host 110-170 ms, once or twice a window, at random.
    gc.collect()
    gc.freeze()

    spans = prof = marks = None
    if traced:
        spans = trace.Spans(program.ops_module(), server)
        spans.install()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        marks = trace.Window()

    if traffic.loop == "closed":
        t_open, t_close = tr.drive_closed(feed, traffic.clients,
                                          traffic.warmup_s, seconds,
                                          marks=marks)
    else:
        if traffic.warmup_s > 0:
            tr.drive_open(feed, tr.arrivals(traffic, seed, traffic.warmup_s,
                                            stream=3))
        since = len(feed.sent)
        due = tr.arrivals(traffic, seed, seconds)
        if marks is not None:
            marks.open()
        t_open, late = tr.drive_open(feed, due)
        if marks is not None:
            marks.close()
        t_close = t_open + seconds
        lateness = tr.summarize_lateness(late)
        log(f"generator lateness over {lateness['n']} submits: " +
            ", ".join(f"{k} {v:.3f}" for k, v in lateness.items()
                      if k != "n"))
    setup_s = t_open - t_start
    if on_card:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    else:
        peak = 0

    summary = None
    if traced:
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        events = trace.from_profiler(prof)
        t_exit = time.perf_counter() - t
        summary = trace.reduce(events)
        log(f"trace: {len(events)} events, profiler stop + read "
            f"{t_exit:.1f} s, reduced in {time.perf_counter() - t - t_exit:.1f}"
            f" s; kernel-1 ranges in the window {len(summary.layer_calls)}, "
            f"calls recorded {len(spans.layer_shapes)}")
        del events, prof
        spans.remove()
        if summary.busy_s <= 0:
            raise RuntimeError("the profiler saw no device time in the "
                               "window")

    completed = feed.requests()
    failed = len(feed.sent) - len(completed)
    if traffic.loop == "closed":
        window_reqs = [r for r in completed if r.t_done >= t_open]
    else:
        window_reqs = feed.requests(since)
    in_window = len(win.completed_in(completed, t_open, t_close))
    run = Run(setup_s=setup_s, t_open=t_open, t_close=t_close,
              requests=window_reqs,
              completed_in_window=in_window,
              flops_per_image=float(config["flops_per_image"]),
              summary=summary)
    if traced:
        run.dispatch_ms = [(e - s) * 1e3 for s, e in spans.dispatch
                           if t_open <= s <= t_close]
        run.micro_batch_device_ms = [ms for t, ms in spans.completes
                                     if t_open <= t <= t_close
                                     and ms is not None]
        run.layer_least_device_s = trace.layer_roofline(summary,
                                                        spans.layer_shapes)
    libs = program.loaded_libraries() if on_card else []
    extra = sorted(set(libs) - set(config["libraries"]))
    if extra:
        log(f"the path loaded libraries the configuration does not list: "
            f"{extra}")

    # The program's state goes before the reference runs.
    del server, ctl, feed, params, spans, images
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_logits = reference_logits(ref, config, seed, traffic.bank, device)
    gap, worst = check.logit_gap(window_reqs, ref_logits)
    log(f"reference over the {traffic.bank}-image bank in "
        f"{time.perf_counter() - t:.2f} s; {len(window_reqs)} requests "
        f"compared, the widest gap at request {worst}")

    limits = config["limits"]
    numbers = {"logit_gap": gap}
    result: Dict[str, Any] = {
        "correct": check.verdict(numbers, limits, failed),
        "attempted": len(window_reqs) + failed,
        "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
    metrics = cell.per_layer if traced else cell.end_to_end
    for m in metrics:
        mod = spec.load_metric(m["name"], cell.root)
        if mod.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: BENCHMARK.json says unit "
                             f"{m['unit']!r}, its file {mod.UNIT!r}")
        value = mod.read(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}
    if summary is not None:
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in summary.device_ops],
            "idle_gaps": [[n[:200], s] for n, s in summary.idle_gaps]}
    return result, {k: (numbers[k], limits[k]) for k in limits}, run


def result_line(result: Dict[str, Any],
                compared: Dict[str, Tuple[float, float]]) -> Dict[str, Any]:
    """The printed result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a traced run's ``breakdown``, and last the
    numbers compared, each with its limit."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        keys.append("breakdown")
    line = {k: result[k] for k in keys}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    return line


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} devices, "
            f"{torch.cuda.device_count()} found")
        return 3
    bad_ref = guard.reference_violations(HERE / "reference")
    if bad_ref:
        log(f"the reference imports what it may not: {bad_ref}")
        return 4

    result, compared, _ = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", t_start)
    loaded = guard.loaded_forbidden(sys.modules)
    if loaded:
        log(f"forbidden modules loaded: {', '.join(loaded)}")
        return 4
    print(json.dumps(result_line(result, compared)), flush=True)
    log(f"correct {result['correct']}")
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
