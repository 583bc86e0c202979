#!/usr/bin/env python3
"""Find an open-loop cell's knee once: the highest offered rate at which
completions keep up with arrivals, no backlog grows over the window and,
where the traffic sets a budget, the 95th percentile meets it.

    python3 portbench/sweep.py --workload deit_s.fp32.poisson \\
        --rates 1200,1400,1600 --seconds 10 --seed 3

One process builds the cell's server once and offers each rate in turn
(the cell's traffic file with ``rate_img_s`` replaced), a warm-up stream
first.  For each rate it prints the images completed a second while
arrivals last, the requests outstanding (due and not yet done) at a
quarter, half, three quarters and the end of the window, the drain after
it, the latency percentiles over every request, the share that missed
the budget, and what the admission layer did: how many micro-batches it
launched at each bucket, how many requests they held, and how often it
held a part-filled bucket back while the ring was busy.  ``--probes``
overrides the traffic's number of latency probes.  The benchmark's runs
never call it; four fifths of the rate it finds is written into the
traffic file.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
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

from harness import program, spec  # noqa: E402
from harness import traffic as tr  # noqa: E402
from harness import window as win  # noqa: E402
from reference import common  # noqa: E402


def outstanding(reqs, t: float) -> int:
    return sum(1 for r in reqs if r.t_due <= t < r.t_done)


def _by_bucket(launched):
    """{bucket: (micro-batches, requests they held)}."""
    out = collections.defaultdict(lambda: [0, 0])
    for bucket, n in launched:
        out[bucket][0] += 1
        out[bucket][1] += n
    return {b: tuple(v) for b, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True,
                    help="comma-separated offered rates, img/s")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probes", type=int, default=None,
                    help="latency probes a bucket (default: the traffic's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    config = cell.config
    base = tr.parse(cell.traffic)
    if args.probes is not None:
        base = dataclasses.replace(base, latency_probes=args.probes)
    if base.loop != "open":
        print(f"{args.workload} is not an open loop", file=sys.stderr)
        return 2
    ref = spec.load_reference(config["family"])
    program.build_libraries(config["libraries"])
    sizes = config["sizes"]
    params = common.make_tree(ref.leaves(sizes), args.seed, "cuda")
    images = list(common.images(args.seed, base.bank, sizes["image"],
                                "cuda").cpu().numpy())
    server, ctl = program.serve(config, base, params, "cuda")
    gc.collect()
    gc.freeze()             # as a run does (run.py)
    print(f"device {torch.cuda.get_device_name(0)}; "
          f"{base.latency_probes} probes; bucket latencies "
          f"{next(iter(ctl.lanes.values())).latencies}", flush=True)
    launched = []               # (bucket, requests) of every dispatch
    dispatch = server.dispatch

    def counted(requests=None, bucket=None):
        inflight = dispatch(requests, bucket)
        if inflight is not None:
            launched.append((inflight.bucket, len(inflight.requests)))
        return inflight
    server.dispatch = counted
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dataclasses.replace(base, rate_img_s=rate)
        feed = tr.Feed(ctl, config["name"], images,
                       tr.image_order(args.seed, base.bank), traffic.sla_ms)
        tr.drive_open(feed, tr.arrivals(traffic, args.seed,
                                        traffic.warmup_s, stream=3))
        since = len(feed.sent)
        n_launched, held = len(launched), ctl.held_partials
        t = time.perf_counter()
        t0, late = tr.drive_open(feed, tr.arrivals(traffic, args.seed,
                                                   args.seconds))
        t_close = t0 + args.seconds
        reqs = feed.requests(since)
        row = {
            "rate_img_s": rate, "requests": len(reqs),
            "completed_per_s": win.rate(reqs, t0, t_close),
            "outstanding": [outstanding(reqs, t0 + f * args.seconds)
                            for f in (0.25, 0.5, 0.75, 1.0)],
            "drain_s": max(r.t_done for r in reqs) - t_close,
            "latency_p50_ms": win.percentile_ms(
                [r.latency_s for r in reqs], 50),
            "latency_p95_ms": win.percentile_ms(
                [r.latency_s for r in reqs], 95),
            "sla_miss_share": (sum(r.latency_s * 1e3 > traffic.sla_ms
                                   for r in reqs) / len(reqs)
                               if traffic.sla_ms else None),
            "lateness": tr.summarize_lateness(late),
            "held_partials": ctl.held_partials - held,
            "buckets": {str(b): [n, filled] for b, (n, filled) in sorted(
                _by_bucket(launched[n_launched:]).items())},
            "wall_s": time.perf_counter() - t,
        }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
