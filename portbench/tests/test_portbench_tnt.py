"""TNT-S under the benchmark, on the CPU: its reference against the port's
own forward and its control against the limit, its tree layout, the
raster order of its pixel tokens as the paper defines it, its operation
count, a tiny TNT cell run end to end, sound and with each planted fault,
the order of its kernel-1 calls and the reader of the inner stream's
share."""

from __future__ import annotations

import dataclasses
import json
import shutil
import time

import pytest

from conftest import BENCH, ROOT, TINY_TRAFFIC
from harness import check, counts_tnt, faults, spec, trace
from reference import common
from reference import tnt as ref_tnt

SEED = 2 ** 31 + 5


def _config():
    return json.loads((BENCH / "configs" / "tnt_s.json").read_text())


def _limit() -> float:
    return _config()["limits"]["logit_gap"]


def _edge():
    """The registry's reduced TNT (`tnt.tnt_edge`): a 4 x 4 patch grid, 4
    pixel tokens a patch, 2 layers; (config, sizes)."""
    from repro_torch.models import tnt
    cfg = tnt.tnt_edge()
    return cfg, {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)}


def _shapes(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shapes(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _shapes(v, path + (i,))
    else:
        yield path, tuple(tree.shape)


def test_reference_matches_the_port_on_cpu():
    from repro_torch.models import tnt, vit
    cfg, sizes = _edge()
    params = common.make_tree(ref_tnt.leaves(sizes), SEED, "cpu")
    images = common.images(SEED, 4, cfg.image, "cpu")
    want = ref_tnt.forward(params, images, sizes).double().numpy()
    got = tnt.forward(params, vit.extract_patches(images, cfg.patch),
                      cfg).double().numpy()
    assert check.row_gaps(got, want).max() < _limit() / 10


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limit(seed):
    """The reference in TF32 (emulated on the CPU) reads above the
    configuration's limit."""
    _, sizes = _edge()
    params = common.make_tree(ref_tnt.leaves(sizes), seed, "cpu")
    images = common.images(seed, 4, sizes["image"], "cpu")
    want = ref_tnt.forward(params, images, sizes, "fp32").double().numpy()
    ctl = ref_tnt.forward(params, images, sizes, "tf32").double().numpy()
    assert check.row_gaps(ctl, want).max() > _limit()


def test_leaves_are_the_ports_tree():
    from repro_torch.models import tnt
    cfg, sizes = _edge()
    made = dict(_shapes(common.make_tree(ref_tnt.leaves(sizes), 1, "cpu")))
    assert made == dict(_shapes(tnt.init_params(cfg)))


def test_leaves_at_tnt_s_widths():
    sizes = _config()["sizes"]
    shapes = {path: shape for path, shape, _, _ in ref_tnt.leaves(sizes)}
    assert shapes[("pixel_embed",)] == (48, 24)
    assert shapes[("patch_embed",)] == (384, 384)
    assert shapes[("layers", 11, "inner", "wq")] == (4, 24, 6)
    assert shapes[("layers", 11, "fold_w")] == (384, 384)
    assert shapes[("layers", 11, "outer", "w_up")] == (384, 1536)
    from math import prod
    assert sum(prod(s) for s in shapes.values()) == 23_753_760


def test_pixel_tokens_are_the_ports_partition():
    import torch

    from repro_torch.core import schedule
    from repro_torch.models import vit
    images = torch.randn((2, 32, 32, 3))
    want = schedule.pixel_partition(vit.extract_patches(images, 16), 16)
    assert torch.equal(ref_tnt.pixel_tokens(images, 16, 4), want)


def test_pixel_tokens_follow_the_papers_raster_order():
    """Written from arXiv:2103.00112's definition, not the program's: the
    image cut into 16 x 16 patches in raster order, each patch into 4 x 4
    sub-patches (its pixel tokens) in raster order; here each sub-patch
    flattened in (row, column, channel) order, `pixel_embed`'s rows."""
    import torch
    b, size, p, ip = 2, 32, 16, 4
    images = torch.arange(b * size * size * 3,
                          dtype=torch.float64).reshape(b, size, size, 3)
    got = ref_tnt.pixel_tokens(images, p, ip)
    grid, sub = size // p, p // ip
    assert got.shape == (b * grid * grid, sub * sub, ip * ip * 3)
    for seq in range(got.shape[0]):
        img, patch = divmod(seq, grid * grid)
        for t in range(sub * sub):
            for e in range(ip * ip * 3):
                (i, j), c = divmod(e // 3, ip), e % 3
                y = p * (patch // grid) + ip * (t // sub) + i
                x = p * (patch % grid) + ip * (t % sub) + j
                assert got[seq, t, e] == images[img, y, x, c]


def test_flops_per_image():
    from repro_torch.core import perfmodel
    cfg = _config()
    flops = counts_tnt.flops_per_image(cfg["sizes"])
    assert cfg["flops_per_image"] == flops == 10_368_368_640
    # the program's count prices every block and fold alike, and the
    # embedding as ViT's (196 patches of 768 to 384)
    macs = perfmodel.count_macs(perfmodel.tnt_s())
    assert 2 * macs.total == 10_418_946_048
    assert flops == 2 * (macs.total - macs.patch_embed
                         + counts_tnt.embed_macs(cfg["sizes"]))
    assert macs.patch_embed == 196 * 768 * 384
    assert counts_tnt.embed_macs(cfg["sizes"]) == \
        196 * 16 * 48 * 24 + 196 * 384 * 384


def _tnt_root(tmp_path):
    """A checkout holding BENCHMARK.json's metrics and one tiny TNT cell,
    ``tnt_tiny.backlog`` (tnt_s.json at `tnt_edge`'s geometry, a closed
    loop of 6), in tnt_s.fp32.backlog's place in the metrics' lists."""
    root = tmp_path / "checkout"
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", root / "portbench" / "metrics")
    _, sizes = _edge()
    sizes = {k: sizes[k] for k in _config()["sizes"]}
    cfg = dict(_config(), name="tnt_tiny", sizes=sizes,
               flops_per_image=counts_tnt.flops_per_image(sizes))
    cfg["program"] = dict(cfg["program"], name="tnt_tiny")
    (root / "portbench/configs/tnt_tiny.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/closed6.json").write_text(
        json.dumps(TINY_TRAFFIC["closed6"]))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tnt_tiny", "source": "test",
                         "file": "portbench/configs/tnt_tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tnt_tiny.backlog", "config": "tnt_tiny",
                           "traffic": "closed6", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tnt_tiny.backlog"]
                              if "tnt_s.fp32.backlog" in m["workloads"]
                              else [])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_tiny_tnt_cell_runs_correct_on_cpu(tmp_path):
    import run as bench_run
    cell = spec.load_cell("tnt_tiny.backlog", _tnt_root(tmp_path))
    assert {m["name"] for m in cell.per_layer} >= {
        "tnt_inner_layer_pct.backlog", "vita_layer_roofline.backlog"}
    result, compared, run = bench_run.run_cell(cell, SEED, 0.4, False, "cpu",
                                               time.perf_counter())
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == {"img_per_s", "setup_s"}
    assert result["attempted"] == len(run.requests) > 0
    assert compared["logit_gap"][0] < compared["logit_gap"][1]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_reads_not_correct_in_a_tiny_tnt_cell(tmp_path, fault):
    import run as bench_run
    cell = spec.load_cell("tnt_tiny.backlog", _tnt_root(tmp_path))
    with faults.planted(fault, cell.config):
        result, compared, _ = bench_run.run_cell(
            cell, SEED, 0.4, False, "cpu", time.perf_counter())
    assert not result["correct"], compared
    value, limit = compared["logit_gap"]
    assert value > limit


def test_kernel_1_calls_alternate_inner_then_outer(tmp_path):
    """The rule `tnt_inner_layer_pct.backlog` reads by: counted from the
    benchmark's span going in, kernel-1 calls 0, 2, 4, ... are the inner
    stream's (N the pixel tokens a patch), 1, 3, 5, ... the outer's."""
    import numpy as np

    from harness import program, traffic as tr
    cell = spec.load_cell("tnt_tiny.backlog", _tnt_root(tmp_path))
    sizes = cell.config["sizes"]
    traffic = tr.parse(cell.traffic)
    params = common.make_tree(ref_tnt.leaves(sizes), SEED, "cpu")
    server, ctl = program.serve(cell.config, traffic, params, "cpu")
    spans = trace.Spans(program.ops_module(), server)
    spans.install()
    try:
        images = common.images(SEED, 5, sizes["image"], "cpu").numpy()
        for im in images:
            ctl.submit(cell.config["name"], np.asarray(im))
        ctl.drain()
    finally:
        spans.remove()
    m = (sizes["patch"] // sizes["inner_patch"]) ** 2
    n = (sizes["image"] // sizes["patch"]) ** 2
    tokens = [s[0][1] for s in spans.layer_shapes]
    assert len(tokens) >= 2 * sizes["layers"]
    assert tokens == [m, n] * (len(tokens) // 2)
    # inner calls carry every patch of the micro-batch as a sequence
    assert all(a[0][0] == b[0][0] * n for a, b in
               zip(spans.layer_shapes[::2], spans.layer_shapes[1::2]))


def _reader():
    return spec.load_metric("tnt_inner_layer_pct.backlog")


def _run(layer_device_s, layer_calls):
    import types
    summary = trace.Summary(window_s=1.0, busy_s=0.9, device_ops=[],
                            idle_gaps=[], layer_device_s=layer_device_s,
                            layer_calls=layer_calls)
    return types.SimpleNamespace(summary=summary)


def test_inner_share_reads_the_even_calls():
    read = _reader().read
    assert read(_run([0.3, 0.1, 0.3, 0.1], [0, 1, 2, 3])) == \
        pytest.approx(75.0)
    # a window that opens on an outer call
    assert read(_run([0.1, 0.3, 0.1, 0.3, 0.1], [5, 6, 7, 8, 9])) == \
        pytest.approx(100 * 0.6 / 0.9)


def test_inner_share_reads_nothing_without_kernel_1_ranges():
    import types
    read = _reader().read
    assert read(_run([], [])) is None
    assert read(types.SimpleNamespace(summary=None)) is None
    assert _reader().LAYER == next(
        m["layer"] for m in spec.load_benchmark(ROOT)["per_layer"]
        if m["name"] == "tnt_inner_layer_pct.backlog")
