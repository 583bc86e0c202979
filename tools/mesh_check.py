"""Phase 6 of chip_smoke.py (the mesh) on every card of a machine: with a
card a rank the ranks meet through NCCL.  Serves DeiT-T and Swin-T on one
device first (the references), then replays, drains and the latency-mesh
stream on meshes sized to the cards, each held against the single
device as chip_smoke.py holds them.

  python3 tools/mesh_check.py          (on a machine with 2 or more cards)
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402


def main() -> None:
    from repro_torch.kernels import build
    from repro_torch.launch.vision_serve import ServeConfig, make_server
    from repro_torch.models import vision_registry

    cards = torch.cuda.device_count()
    if cards < 2:
        raise SystemExit("tools/mesh_check.py needs two cards or more")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cfgs = {m: vision_registry.build_cfg(m, full=True)
            for m in ("deit_t", "swin_t")}
    images = {m: np.random.default_rng(0).standard_normal(
        (19, c.image, c.image, 3)).astype(np.float32)
        for m, c in cfgs.items()}
    params = {m: vision_registry.init_params(c, seed=0, device="cuda")
              for m, c in cfgs.items()}
    quant, served = {}, {}
    for m in cfgs:
        for mode in ("float", "int8"):
            srv = make_server(m, ServeConfig(mode=mode, buckets=cs.BUCKETS,
                                             full=True), params=params[m])
            reqs = srv.submit_many(images[m])
            srv.run()
            served[(m, mode, True, 1)] = {
                "server": srv, "logits": np.stack([r.logits for r in reqs])}
            if mode == "int8":
                quant[(m, 1)] = (srv.qparams, srv.calibrator)
    model_mesh, data_mesh = f"1x{cards}", f"{cards}x1"
    replays = [("deit_t", shape, mode, fused, 1)
               for shape in (model_mesh, data_mesh, "1x3", "2x2")
               if int(np.prod([int(v) for v in shape.split("x")])) <= cards
               for mode in ("float", "int8") for fused in (True, False)]
    replays += [("swin_t", model_mesh, mode, True, 1)
                for mode in ("float", "int8")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(smi))
    where = f"{cards} x {smi[0]}"
    counts = cs.mesh_phase(served, params, quant, images, where, t0,
                           replays=replays,
                           drains=((model_mesh, 11), (data_mesh, 5)),
                           latency_mesh=model_mesh)
    print({k: v for k, v in counts.items() if v})
    print(f"[mesh-check] ok in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
