#!/usr/bin/env python3
"""The control and the planted faults, on the card at the cells' own
sizes and load: each is a whole run of the cell (`run.run_cell`: the
cell's server, traffic and window, then the comparison with the float32
reference that decides ``correct``) with the fault of `harness.faults`
planted underneath the program, and ``none`` the sound run.

    python3 portbench/control.py --workloads deit_s.fp32.backlog \\
        --faults none,control_tf32,half_batch --seeds 1,2,3 --seconds 5

One process runs every (workload, fault, seed) in turn and prints one
JSON line each: ``correct`` as the run decides it, and each number
compared beside its limit.  Last, for each (workload, fault): the
readings' range and whether every run read as it should (the sound runs
correct, the others not).  It exits 1 when one did not.  The benchmark's
runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import faults, spec  # noqa: E402
from run import run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--faults", default="none," + ",".join(faults.FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    names = args.faults.split(",")
    as_expected = True
    for workload in args.workloads.split(","):
        cell = spec.load_cell(workload)
        for fault in names:
            gaps, verdicts = [], []
            for seed in seeds:
                with faults.planted(fault, cell.config):
                    result, compared, _ = run_cell(
                        cell, seed, args.seconds, False, "cuda",
                        time.perf_counter())
                gaps.append(compared["logit_gap"][0])
                verdicts.append(result["correct"])
                print(json.dumps({
                    "workload": workload, "fault": fault, "seed": seed,
                    "correct": result["correct"],
                    "attempted": result["attempted"],
                    "failed": result["failed"],
                    "compared": {k: {"value": v, "limit": lim}
                                 for k, (v, lim) in compared.items()}}),
                    flush=True)
            ok = all(verdicts) if fault == "none" else not any(verdicts)
            as_expected &= ok
            print(json.dumps({
                "workload": workload, "fault": fault, "seeds": len(seeds),
                "logit_gap_min": min(gaps), "logit_gap_max": max(gaps),
                "correct": verdicts, "as_expected": ok,
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if as_expected else 1


if __name__ == "__main__":
    sys.exit(main())
