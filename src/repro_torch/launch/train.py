"""End-to-end training driver (counterpart of `repro/launch/train.py`):
resumable and fault-tolerant, on the card by default.

  * deterministic stateless data stream (`SyntheticLM.batch_at(step)`),
    so a restart replays the exact schedule;
  * checkpoint / restore with atomic commits (``--resume`` picks up the
    latest, onto this run's device, whatever the saving run's was);
  * preemption guard (SIGTERM -> save + clean exit) and step watchdog
    (straggler detection);
  * optional int8 error-feedback gradient compression (``--compress``).

The JAX launcher's docstring names ``--accum`` (microbatch gradient
accumulation), which it does not implement; neither does the port.

Usage (the card; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --reduced --steps 200 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.distributed.ft import PreemptionGuard, StepWatchdog
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.vision_serve import resolve_device
from repro_torch.models import transformer as tr
from repro_torch.optim import AdamWConfig, linear_warmup_cosine


def build_config(args):
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.seq and cfg.window:
        cfg = dataclasses.replace(cfg, window=min(cfg.window, args.seq))
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--deadline-s", type=float, default=120.0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    cfg = build_config(args)
    device = resolve_device(args.device)
    print(f"[train] {cfg.name} reduced={args.reduced} "
          f"layers={cfg.n_layers} d={cfg.d_model} on {device}")

    params = tr.init_params(cfg, args.seed, device)
    opt_state = steps_lib.init_opt_state(params, args.compress)
    print(f"[train] {tr.param_count(params) / 1e6:.2f}M params")

    lr_fn = linear_warmup_cosine(args.lr, args.warmup, args.steps)
    step_fn = steps_lib.make_train_step(cfg, AdamWConfig(), lr_fn,
                                        grad_compression=args.compress)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
        if args.resume:
            latest = mgr.latest_step()
            if latest is not None:
                state = mgr.restore(latest, {"params": params,
                                             "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                start_step = latest + 1
                print(f"[train] resumed from step {latest}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=args.seed,
                       n_image_tokens=cfg.n_image_tokens,
                       d_model=cfg.d_model, input_mode=cfg.input_mode)

    def stream():
        s = start_step
        while True:
            yield data.batch_at(s)
            s += 1

    prefetch = Prefetcher(stream(), depth=2)
    guard = PreemptionGuard(install=False)   # SIGTERM only in real runs
    watchdog = StepWatchdog(args.deadline_s)

    history = []
    t_start = time.time()
    step = start_step
    for batch in prefetch:
        if step >= args.steps or guard.requested:
            break
        watchdog.start()
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        watchdog.check(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t_start
            print(f"[step {step:5d}] loss={m['loss']:.4f} "
                  f"ce={m['ce_loss']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} ({dt:.1f}s)")
            history.append({"step": step, **m})
        if mgr and step > 0 and step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state})
        step += 1
    prefetch.stop()

    if mgr:
        mgr.save(step - 1, {"params": params, "opt": opt_state})
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    print(f"[train] done: {step - start_step} steps in "
          f"{time.time() - t_start:.1f}s; final loss "
          f"{history[-1]['loss'] if history else float('nan'):.4f}")
    return history


if __name__ == "__main__":
    main()
