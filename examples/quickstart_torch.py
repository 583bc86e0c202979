"""Quickstart of the PyTorch/CUDA port: the ViTA building blocks in a
minute (the port's counterpart of `examples/quickstart.py`).

1. Run the paper's analytical model -> Table IV numbers.
2. Push a ViT through the float and int8-PTQ inference paths.
3. Call the fused-MLP and head-streamed-attention ops directly: on the
   card they launch the port's kernels (6 and 9), held here against
   their plain PyTorch versions on the same inputs.

Run:  PYTHONPATH=src python examples/quickstart_torch.py   (the card)
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch.core import perfmodel as pm                # noqa: E402
from repro_torch.core.quant import Calibrator               # noqa: E402
from repro_torch.kernels import ops, ref                    # noqa: E402
from repro_torch.launch.vision_serve import resolve_device  # noqa: E402
from repro_torch.models import vit                          # noqa: E402

# a kernel and its plain version agree within this share of the output's
# scale (split-TF32 and reassociated float32 sums)
KERNEL_TOL = 1e-3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- 1. the paper's accelerator model ---------------------------------
    report = pm.analyze(pm.PAPER_MODELS["vit_b16_256"])
    print(f"ViT-B/16@256 on ViTA(16x6, 8x4 @150MHz): "
          f"HUE={report.hue*100:.1f}%  fps={report.fps:.2f}  "
          f"energy={report.energy_j:.3f} J   (paper: 93.2%, 2.17, 0.406)")

    # --- 2. int8 PTQ inference (the paper's deployment mode) --------------
    cfg = vit.ViTConfig(name="demo", image=64, patch=16, dim=128, heads=4,
                        layers=2, n_classes=10)
    params = vit.init_params(cfg, 0, dev)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand((4, 64, 64, 3), generator=gen).to(dev)
    patches = vit.extract_patches(images, cfg.patch)
    with torch.inference_mode():
        logits_fp = vit.forward(params, patches, cfg)
        qparams = vit.quantize_vit(params)
        cal = Calibrator()
        vit.forward(qparams, patches, cfg, observer=cal)   # calibration
        cal.freeze(dev)
        logits_q = vit.forward(qparams, patches, cfg, observer=cal)
    err = float((logits_q - logits_fp).abs().max())
    agree = bool((logits_q.argmax(-1) == logits_fp.argmax(-1)).all())
    print(f"int8 PTQ: max logit delta {err:.4f}; argmax match: {agree}")

    # --- 3. the kernels themselves -----------------------------------------
    g = torch.Generator().manual_seed(2)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    x, w1, w2 = randn(256, 128), randn(128, 512, scale=0.05), \
        randn(512, 128, scale=0.05)
    q, k, v = randn(1, 4, 128, 64), randn(1, 2, 128, 64), randn(1, 2, 128, 64)
    with torch.inference_mode():
        y = ops.mlp(x, w1, w2, activation="gelu")
        y_plain = ref.fused_mlp_ref(x, w1, None, w2, None,
                                    activation="gelu")
        o = ops.attention(q, k, v, causal=True)
        o_plain = ref.attention_ref(q, k, v, causal=True)
    mlp_err = float((y - y_plain).abs().max())
    att_err = float((o - o_plain).abs().max())
    print(f"fused MLP (kernel on {dev.type} vs plain): max err "
          f"{mlp_err:.2e} (the (N,M) hidden was never materialized)")
    print(f"head-streamed attention (GQA 4:2): max err {att_err:.2e}")
    for name, e, out in (("fused MLP", mlp_err, y_plain),
                         ("attention", att_err, o_plain)):
        if not e <= KERNEL_TOL * float(out.abs().max()):
            raise SystemExit(f"{name}: the kernel is {e:.3e} from its "
                             f"plain version")
    print("done.")
    return {"hue": report.hue, "ptq_err": err, "argmax_match": agree,
            "mlp_err": mlp_err, "attention_err": att_err}


if __name__ == "__main__":
    main()
