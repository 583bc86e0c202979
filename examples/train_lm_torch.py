"""End-to-end training driver of the port (the counterpart of
`examples/train_lm.py`): train a ~100M-param LM for a few hundred steps
on the synthetic pseudo-language stream, with checkpointing.

It drives the port's real training path (`repro_torch.launch.train`):
the same step function, optimizer, checkpoint manager and data pipeline;
on the card the fused MLP and the attention are kernels 6 and 9.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
      (~100M params; --small for the reduced config, --device cpu for
      the plain PyTorch path)
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import configs                             # noqa: E402
from repro_torch.launch import train as train_mod           # noqa: E402
from repro_torch.models import transformer as tr            # noqa: E402
from repro_torch.models.config import ModelConfig           # noqa: E402


def lm_100m() -> ModelConfig:
    """~100M-param dense LM (the danube family scaled down)."""
    base = configs.get("h2o-danube-1.8b")
    return dataclasses.replace(
        base, name="danube-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=8192, window=256,
        dtype="float32", vocab_pad_multiple=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)

    cfg = lm_100m()
    n = tr.param_count(tr.init_params(cfg, 0, "meta"))
    print(f"[example] {cfg.name}: {n/1e6:.1f}M params")

    device = [] if args.device is None else ["--device", args.device]
    if args.small:
        hist = train_mod.main([
            "--arch", "h2o-danube-1.8b", "--reduced",
            "--steps", str(min(args.steps, 100)),
            "--batch", "8", "--seq", "64", "--log-every", "10",
            "--ckpt-dir", args.ckpt, "--ckpt-every", "40"] + device)
    else:
        hist = _run_custom(cfg, args, device)
    print(f"[example] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


def _run_custom(cfg, args, device):
    """Drive launch.train's loop with a custom (non-registry) config."""
    orig = train_mod.build_config
    train_mod.build_config = lambda a: cfg
    try:
        return train_mod.main(["--arch", "h2o-danube-1.8b",
                               "--steps", str(args.steps), "--batch", "4",
                               "--seq", "256", "--log-every", "20",
                               "--ckpt-dir", args.ckpt, "--ckpt-every",
                               "100", "--lr", "3e-4"] + device)
    finally:
        train_mod.build_config = orig


if __name__ == "__main__":
    main()
