"""Serve a small vision transformer with batched requests through the
port's int8-quantized ViTA inference path (the port's counterpart of
`examples/serve_quantized_vit.py`).

Pipeline: build the registry's ``vit_edge`` model -> train it briefly on
the synthetic class-blob task (AdamW; on the card every encoder layer's
forward is kernel 1, its gradient the plain version's autograd) ->
post-training quantize (per-channel weights, calibrated activations) ->
serve batched image requests through the `VisionServer` micro-batcher
(float: kernel 1 a layer; int8: kernel 2 a layer, kernel 4 for the
embedding and the head), reporting throughput, p50/p99 latency,
int8-vs-fp32 agreement, and the ViTA-model fps estimate for the same
network on the FPGA target.

Run:  PYTHONPATH=src python examples/serve_quantized_vit_torch.py
      PYTHONPATH=src python examples/serve_quantized_vit_torch.py \\
          --device cpu
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

from repro_torch import tree as tree_lib                    # noqa: E402
from repro_torch.core import perfmodel as pm                # noqa: E402
from repro_torch.data import SyntheticImages                # noqa: E402
from repro_torch.launch.vision_serve import (ServeConfig,   # noqa: E402
                                             VisionServer, calibrate,
                                             resolve_device)
from repro_torch.models import vision_registry, vit         # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,     # noqa: E402
                               adamw_update, decays_by_own_rank)


def loss_fn(params, images, labels, cfg):
    logits = vit.forward(params, vit.extract_patches(images, cfg.patch), cfg)
    return -torch.mean(torch.gather(torch.log_softmax(logits, -1), 1,
                                    labels[:, None]))


def train_step(params, state, images, labels, cfg, lr):
    """One AdamW step on the loss's gradient: (params, state, loss)."""
    flat = tree_lib.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss = loss_fn(tree_lib.unflatten(params, live), images, labels, cfg)
        grads = torch.autograd.grad(loss, live)
    params, state, _ = adamw_update(
        tree_lib.unflatten(params, list(grads)), state, params, lr,
        AdamWConfig(), decay=decays_by_own_rank)
    return params, state, loss.detach()


def main(argv=None, *, steps: int = 80, batch: int = 32,
         serve_batches: int = 4) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    cfg = vision_registry.build_cfg("vit_edge")
    data = SyntheticImages(image=cfg.image, n_classes=cfg.n_classes,
                           batch=batch, seed=0)
    params = vision_registry.init_params(cfg, 0, dev)

    # -- brief training ------------------------------------------------
    state = adamw_init(params)
    lr = torch.tensor(1e-3)
    losses, step_ms = [], []
    for i in range(steps):
        b = data.batch_at(i)
        t0 = time.perf_counter()
        params, state, loss = train_step(
            params, state, torch.from_numpy(b["images"]).to(dev),
            torch.from_numpy(b["labels"]).long().to(dev), cfg, lr)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if steps:
        print(f"[train] {steps} AdamW steps: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; step {np.median(step_ms):.2f} ms (median)")

    # -- PTQ -------------------------------------------------------------
    qparams = vit.quantize_vit(params)
    cal = calibrate(qparams, cfg, np.concatenate(
        [data.batch_at(1000 + i)["images"] for i in range(4)]), device=dev)

    # -- batched serving (VisionServer micro-batcher) ----------------------
    imgs = np.concatenate([data.batch_at(2000 + i)["images"]
                           for i in range(serve_batches)])
    labels = np.concatenate([data.batch_at(2000 + i)["labels"]
                             for i in range(serve_batches)])
    results = {}
    for mode in ("float", "int8"):
        server = VisionServer(
            cfg, params, qparams=qparams, calibrator=cal,
            serve_cfg=ServeConfig(mode=mode, buckets=(1, 2, 4, 8, 16, 32),
                                  device=str(dev)))
        server.submit_many(imgs)
        stats = server.run()
        results[mode] = (stats, np.asarray([r.pred for r in server.done]))
        print(f"[serve] {mode}: {stats['requests']} images in "
              f"{stats['wall_s']:.2f}s -> {stats['throughput_img_s']:.1f} "
              f"img/s, p50 {stats['latency_p50_ms']:.1f}ms "
              f"p99 {stats['latency_p99_ms']:.1f}ms")
    pred_f, pred_q = results["float"][1], results["int8"][1]
    top1 = float((pred_q == labels).mean())
    agreement = float((pred_q == pred_f).mean())
    print(f"[serve] int8 top-1 {top1*100:.2f}%  "
          f"int8==fp32 agreement {agreement*100:.2f}%")

    # -- what would ViTA do with this network? ---------------------------
    r = pm.analyze(vit.to_spec(cfg))
    print(f"[vita-model] same net on ViTA@150MHz: {r.fps:.0f} fps at "
          f"{pm.VitaHW().power_w} W (HUE {r.hue*100:.0f}%)")
    return {"losses": losses, "step_ms": step_ms, "top1": top1,
            "agreement": agreement,
            "stats": {m: results[m][0] for m in results}}


if __name__ == "__main__":
    main()
