#!/usr/bin/env python3
"""Live per-phase HUE report of the PyTorch/CUDA port: measured against
modelled cycle attribution (the port's counterpart of
`tools/hue_report.py`, with the same flags and exit codes, plus
``--device``).

For each registered vision model (float and int8) this runs the per-phase
profile replay (`repro_torch.core.schedule.profile_schedule`: a CUDA event
pair and a wait per phase on the card, warmup + best-of repeats) through
`VisionServer.profile_stats`, and joins the measured timings with the
analytic ViTA cycle / MAC attribution (`core.perfmodel`) into the op-wise
table of `core.hue`: phase kind, calls, measured ms and share, modelled ms
and share, modelled HUE and measured HUE (a ViTA-clock equivalent, not a
share of the card's peak: the note under every table says so).

``--fusion-warn BENCH.json`` skips profiling and prints one GitHub
``::warning::`` line per fused bench row measured below 1.0x; it exits 0
(report-only), and 2 on bad JSON.

``--fusion-data`` has no default: the JAX tool's default file was
measured on a CPU host.  Without it ``--fusion-policy auto`` falls back to
the modelled default (fuse) and says so.

Run (the card by default; ``--device cpu`` runs the plain versions):
  PYTHONPATH=src python tools/hue_report_torch.py
  python tools/hue_report_torch.py --models deit_t --mode int8 --batch 8
  python tools/hue_report_torch.py --device cpu --models vit_edge \\
      --json-out /tmp/hue.json
  python tools/hue_report_torch.py --fusion-warn BENCH.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

import numpy as np                                           # noqa: E402
import torch                                                 # noqa: E402

from repro_torch.core import hue as hue_lib                  # noqa: E402
from repro_torch.core.schedule import FusionPolicy           # noqa: E402
from repro_torch.launch.vision_serve import (ServeConfig,    # noqa: E402
                                             VisionServer, calibrate,
                                             hue_table, resolve_device)
from repro_torch.models import vision_registry               # noqa: E402

CRASH_EXIT = 2


def profile_model(name: str, mode: str, *, batch: int, warmup: int,
                  repeats: int, policy, seed: int = 0,
                  group_size: int = 1, mesh_shape: str = None,
                  device=None) -> dict:
    """One (model, mode) HUE report through `VisionServer.profile_stats`,
    the entry point a live server exposes.  ``group_size > 1`` profiles
    the layer-group chain."""
    dev = resolve_device(device)
    cfg = vision_registry.build_cfg(name, fuse_group=group_size)
    params = vision_registry.init_params(cfg, seed, dev)
    qparams = cal = None
    if mode == "int8":
        qparams = vision_registry.quantize(params)
        rng = np.random.default_rng(seed)
        calib = rng.standard_normal(
            (4, cfg.image, cfg.image, 3)).astype(np.float32)
        cal = calibrate(qparams, cfg, calib, device=dev, n_batches=2)
    server = VisionServer(
        cfg, params, qparams=qparams, calibrator=cal,
        serve_cfg=ServeConfig(mode=mode, buckets=(batch,),
                              fusion_policy=policy, mesh_shape=mesh_shape,
                              device=str(dev)),
        model_name=name)
    return server.profile_stats(batch, warmup=warmup, repeats=repeats)


def fusion_warn(path: str) -> int:
    """Print a ``::warning::`` annotation per measured fused regression."""
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"[hue-report] ERROR: {type(e).__name__}: {e}",
              file=sys.stderr)
        return CRASH_EXIT
    regs = hue_lib.fusion_regressions(record)
    if not regs:
        print(f"[hue-report] {path}: no fused rows measured below 1.0x — "
              f"every fused configuration is a measured win")
        return 0
    for r in regs:
        variant = (f"grouped(x{r['group_size']})"
                   if r.get("group_size", 1) > 1 else "fused")
        mesh = r.get("mesh_shape", f"{r['devices']}x1")
        print(f"::warning title=fused slower than unfused::"
              f"{r['model']} {r['mode']} batch={r['batch']} "
              f"devices={r['devices']} mesh={mesh}: measured {variant} "
              f"fusion_speedup "
              f"{r['fusion_speedup']:.3f} < 1.0 — 'always' ships a loss "
              f"here; '--fusion-policy auto' serves it unfused")
    print(f"[hue-report] {path}: {len(regs)} fused configuration(s) "
          f"measured slower than unfused (report-only; exit 0)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="hue_report_torch",
        description="Per-phase measured-vs-modelled HUE table for the "
                    "registered vision models, on the port")
    ap.add_argument("--models", default=None,
                    help="comma-separated registry names "
                         "(default: every registered model)")
    ap.add_argument("--mode", choices=("float", "int8", "both"),
                    default="both")
    ap.add_argument("--batch", type=int, default=4,
                    help="micro-batch size profiled")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed replays before timing (kernel builds)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed replays (per-phase best kept)")
    ap.add_argument("--fusion-policy", choices=FusionPolicy.MODES,
                    default=None,
                    help="profile the variant this policy would serve "
                         "(default: the config's fused schedule)")
    ap.add_argument("--fusion-data", default=None,
                    help="bench JSON measured on the card, seeding the "
                         "'auto' policy (no default)")
    ap.add_argument("--fuse-group-size", type=int, default=1,
                    help="profile the layer-group chain at this group "
                         "size (1 = per-layer fused chain)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve through a (data, model) mesh of this "
                         "shape; the replay stays on rank 0's device "
                         "(attribution, not mesh latency), the reports "
                         "are tagged with the shape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write every report as one JSON record")
    ap.add_argument("--fusion-warn", metavar="BENCH_JSON", default=None,
                    help="scan-only mode: print ::warning:: annotations "
                         "for fused bench rows measured below 1.0x and "
                         "exit 0 (no profiling)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    if args.fusion_warn:
        return fusion_warn(args.fusion_warn)

    registered = vision_registry.list_models()
    models = (args.models.split(",") if args.models else list(registered))
    unknown = [m for m in models if m not in registered]
    if unknown:
        raise SystemExit(
            f"[hue-report] unknown model(s): {', '.join(unknown)}; "
            f"registered models are: {', '.join(registered)}")
    modes = ("float", "int8") if args.mode == "both" else (args.mode,)

    if args.fuse_group_size < 1:
        raise SystemExit("[hue-report] --fuse-group-size must be >= 1")
    policy = None
    if args.fusion_policy == "auto":
        if args.fusion_data and os.path.exists(args.fusion_data):
            policy = FusionPolicy.from_bench(
                args.fusion_data, default_group=args.fuse_group_size)
        else:
            what = (f"--fusion-data {args.fusion_data} not found"
                    if args.fusion_data else "no --fusion-data given")
            print(f"[hue-report] WARNING: {what}; 'auto' falls back to "
                  f"the modelled default (fuse)")
            policy = FusionPolicy(mode="auto",
                                  default_group=args.fuse_group_size)
    elif args.fusion_policy:
        policy = FusionPolicy(mode=args.fusion_policy,
                              default_group=args.fuse_group_size)

    reports = []
    for name in models:
        for mode in modes:
            report = profile_model(name, mode, batch=args.batch,
                                   warmup=args.warmup,
                                   repeats=args.repeats,
                                   policy=policy, seed=args.seed,
                                   group_size=args.fuse_group_size,
                                   mesh_shape=args.mesh, device=args.device)
            reports.append(report)
            print(hue_table(
                report,
                title=f"{name} ({report['config']}) mode={mode} "
                      f"fused={report['fused']} "
                      f"group={report.get('group_size', 1)} "
                      f"batch={report['batch']}"))
            print()

    if args.json_out:
        record = {"bench": "hue_report", "models": models,
                  "modes": list(modes), "batch": args.batch,
                  "repeats": args.repeats,
                  "fusion_policy": args.fusion_policy,
                  "fuse_group_size": args.fuse_group_size,
                  "device_count": torch.cuda.device_count(),
                  "mesh": args.mesh,
                  "reports": reports}
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"[hue-report] wrote {args.json_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
