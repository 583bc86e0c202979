"""Shared fixtures of the benchmark's CPU tests: the import paths, the
``cuda`` marker (a test that needs the card skips here, decided in the
``card`` fixture), and a checkout of tiny cells to drive the harness on
the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


TINY_SIZES = {
    "vit_tiny": ("deit_s", {"image": 32, "patch": 8, "dim": 64, "heads": 2,
                            "layers": 2, "mlp_ratio": 4.0, "n_classes": 10}),
    # swin_edge's geometry: two stages, shifted 7x7 windows, one merge
    "swin_tiny": ("swin_t", {"image": 56, "patch": 4, "embed_dim": 48,
                             "depths": [2, 2], "heads": [3, 6], "window": 7,
                             "mlp_ratio": 4.0, "n_classes": 10}),
}
TINY_TRAFFIC = {
    "closed6": {"loop": "closed", "clients": 6, "sla_ms": None,
                "buckets": [1, 2, 4], "bank": 8, "warmup_s": 0.1},
    "open300": {"loop": "open", "rate_img_s": 300, "sla_ms": 50,
                "buckets": [1, 2, 4], "bank": 8, "warmup_s": 0.1},
}


def write_tiny_root(root: Path) -> Path:
    """A checkout holding BENCHMARK.json's metrics and three tiny cells
    (a ViT and a Swin backlog, a ViT open loop) whose configurations copy
    DeiT-S's and Swin-T's files at CPU sizes."""
    from harness import counts
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", root / "portbench" / "metrics")
    bench["configs"] = []
    for name, (base, sizes) in TINY_SIZES.items():
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, sizes=sizes,
                   flops_per_image=counts.flops_per_image(cfg["family"],
                                                          sizes))
        cfg["program"] = dict(cfg["program"], name=name)
        path = f"portbench/configs/{name}.json"
        (root / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
    for name, params in TINY_TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(params))
    cells = {"deit_s.fp32.backlog": ("vit_tiny.backlog", "vit_tiny",
                                     "closed6"),
             "swin_t.fp32.backlog": ("swin_tiny.backlog", "swin_tiny",
                                     "closed6"),
             "deit_s.fp32.poisson": ("vit_tiny.poisson", "vit_tiny",
                                     "open300")}
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, c, t in cells.values()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cells[w][0] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path / "checkout")


@pytest.fixture
def run_tiny(tiny_root):
    """Run a tiny cell on the CPU: (result, compared, run)."""
    import time

    import run as bench_run
    from harness import spec

    def go(workload, seed=2 ** 31 + 11, seconds=0.4, traced=False):
        cell = spec.load_cell(workload, tiny_root)
        return bench_run.run_cell(cell, seed, seconds, traced, "cpu",
                                  time.perf_counter())
    return go
