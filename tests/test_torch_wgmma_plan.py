"""Kernel 1's fp32 GEMM on the wgmma route (`vita_layer.gemm_wgmma_plan`,
`layer_gemm_plan`, `weight_planes`) on the CPU: no card needed.

* Every product the registry's models make in float mode, at buckets 1, 8
  and 32, and the benchmark cells' shapes, gets a tile whose ring fits a
  block's 232,448 bytes and whose tiles cover M and N, in the waves the
  plan states.
* The route: fp32 weights with 16-byte aligned rows of A take it; bf16
  weights and unaligned rows take the mma.sync tile, and so does the
  float layer group, whose kernel embeds that tile.
* An output element's k order (32-deep stages from k = 0) depends on K
  alone, never on M or N.
* The weights' hi and lo planes are split once, by the kernels' integer
  TF32 rounding, made again after an in-place update and dropped with the
  weight.
* `launch_layer_gemm` counts kernel 1's products, the part on the wgmma
  route and that route's tiles while tracing is on (the launch stubbed
  out), and nothing while it is off.
"""

import gc
import weakref
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.kernels import vita_layer as vl
from repro_torch.models import vision_registry

_BUCKETS = (1, 8, 32)
_CSRC = Path(vl.__file__).resolve().parents[1] / "csrc"


def _heads_kept(cfg, heads, stage=None):
    """The head counts a (pruned) model's layers keep."""
    if cfg.head_mask is None:
        return {heads}
    rows = cfg.head_mask if stage is None else cfg.head_mask[stage]
    return {sum(r) for r in rows}


def _products():
    """(model, M, N, K) of every float product kernel 1 runs for the
    registry's models, full and reduced, at each of _BUCKETS: concat
    (K = the heads kept x Dh), up and down, per Swin stage and for both
    TNT streams."""
    out = set()
    for name in vision_registry.list_models():
        for full in (True, False):
            cfg = vision_registry.build_cfg(name, full=full)
            streams = []
            if hasattr(cfg, "depths"):
                for s in range(len(cfg.depths)):
                    d = cfg.stage_dim(s)
                    dh = d // cfg.heads[s]
                    streams.append((cfg.stage_side(s) ** 2, d, int(
                        d * cfg.mlp_ratio), {dh * h for h in _heads_kept(
                            cfg, cfg.heads[s], s)}))
            else:
                streams.append((cfg.tokens, cfg.dim, int(
                    cfg.dim * cfg.mlp_ratio), {cfg.head_dim * h for h in
                                               _heads_kept(cfg, cfg.heads)}))
            if hasattr(cfg, "inner_tokens"):
                streams.append((cfg.tokens * cfg.inner_tokens, cfg.inner_dim,
                                int(cfg.inner_dim * cfg.inner_mlp_ratio),
                                {cfg.inner_heads * cfg.inner_head_dim}))
            for tokens, d, m, concat_ks in streams:
                for b in _BUCKETS:
                    rows = b * tokens
                    out.update((name, rows, d, k) for k in concat_ks)
                    out.update({(name, rows, m, d), (name, rows, d, m)})
    return sorted(out)


# The benchmark cells' products (M x N x K): DeiT-S and TNT-S's outer
# stream at bucket 32, Swin-T's stages 1 and 4, TNT-S's inner stream, the
# Poisson cell's one- and sixteen-image buckets; and the tile and waves
# the plan gives each.
_CELLS = [
    ((6272, 384, 384), (64, 96, 392, 3)),
    ((6272, 1536, 384), (128, 96, 784, 6)),
    ((6272, 384, 1536), (128, 96, 196, 2)),
    ((100352, 96, 96), (128, 96, 784, 6)),
    ((100352, 384, 96), (128, 64, 4704, 36)),
    ((100352, 96, 384), (128, 96, 784, 6)),
    ((1568, 768, 3072), (128, 96, 104, 1)),
    ((100352, 24, 24), (128, 32, 784, 6)),
    ((100352, 96, 24), (128, 96, 784, 6)),
    ((100352, 24, 96), (128, 32, 784, 6)),
    ((196, 1536, 384), (128, 32, 96, 1)),
    ((196, 384, 1536), (64, 32, 48, 1)),
    ((3136, 384, 1536), (128, 96, 100, 1)),
]


def test_products_cover_the_registry():
    shapes = {(m, n, k) for _, m, n, k in _products()}
    models = {name for name, _, _, _ in _products()}
    assert set(vision_registry.list_models()) <= models
    assert {(6272, 384, 384), (6272, 1536, 384), (6272, 384, 1536),
            (100352, 96, 96), (100352, 24, 24), (100352, 96, 24),
            (100352, 24, 96), (1568, 768, 3072)} <= shapes
    # a pruned layer's concat keeps fewer heads
    assert (196, 192, 128) in shapes


def _fits(m, n, k):
    plan = vl.gemm_wgmma_plan(m, n, k)
    assert plan.bm == 64 * plan.consumers and plan.consumers in (1, 2)
    assert plan.bn in vl.WG_WIDTHS and plan.bn % 8 == 0
    assert 2 <= plan.stages <= vl.WG_MAX_STAGES
    assert plan.smem == vl.wgmma_smem(plan.bm, plan.bn, plan.stages)
    assert plan.smem <= build.SMEM_LIMIT
    assert (plan.stages == vl.WG_MAX_STAGES or vl.wgmma_smem(
        plan.bm, plan.bn, plan.stages + 1) > build.SMEM_LIMIT)
    mt, nt = -(-m // plan.bm), -(-n // plan.bn)
    assert plan.tiles == mt * nt
    assert mt * plan.bm >= m > (mt - 1) * plan.bm
    assert nt * plan.bn >= n > (nt - 1) * plan.bn
    assert plan.waves == -(-plan.tiles // vl.H100_SMS)
    return plan


@pytest.mark.parametrize("model,m,n,k", _products())
def test_every_registry_product_has_a_plan_that_fits(model, m, n, k):
    _fits(m, n, k)


@pytest.mark.parametrize("mnk,want", _CELLS)
def test_cell_shapes_get_their_tile_and_waves(mnk, want):
    plan = _fits(*mnk)
    assert (plan.bm, plan.bn, plan.tiles, plan.waves) == want


def test_the_plan_takes_the_least_time_by_its_table():
    """Every other tile, by the same measured table, takes no less time."""
    for (m, n, k), _ in _CELLS:
        plan = vl.gemm_wgmma_plan(m, n, k)
        steps = -(-k // vl.WG_BK)

        def us(bn, c):
            tiles = -(-m // (64 * c)) * -(-n // bn)
            return -(-tiles // vl.H100_SMS) * (
                steps * vl.WG_STAGE_US[bn, c] + vl.WG_EPILOGUE_US[bn, c])

        best = us(plan.bn, plan.consumers)
        assert all(best <= us(bn, c) for bn, c in vl.WG_STAGE_US)


def test_the_k_order_depends_on_k_alone():
    """The kernel walks K in WG_BK-deep stages from k = 0 whatever the
    tile: a row's sum is the same sequence of chunks at any M or N."""
    for k in (24, 96, 384, 1536, 3072, 100):
        chunks = {(vl.WG_BK, -(-k // vl.WG_BK))}
        for m in (1, 16, 196, 3136, 6272, 100352):
            for n in (24, 96, 384, 1536):
                plan = vl.gemm_wgmma_plan(m, n, k)
                assert plan.bn in vl.WG_WIDTHS
                chunks.add((vl.WG_BK, -(-k // vl.WG_BK)))
        assert len(chunks) == 1
    src = (_CSRC / "gemm_wgmma.cuh").read_text()
    assert "s * WG_BK" in src
    assert "atomicAdd" not in src and "red.global" not in src


def test_route_takes_fp32_aligned_rows():
    a = torch.zeros((196, 384))
    assert a.data_ptr() % 16 == 0
    w = torch.zeros((384, 1536))
    assert vl.layer_gemm_plan(a, w) == vl.gemm_wgmma_plan(196, 1536, 384)


def test_route_leaves_bf16_weights_and_unaligned_rows_to_the_old_tile():
    a = torch.zeros((196, 384))
    assert vl.layer_gemm_plan(a, torch.zeros((384, 96),
                                             dtype=torch.bfloat16)) is None
    buf = torch.zeros(196 * 384 + 1)
    shifted = buf[1:].view(196, 384)          # rows 4 bytes off 16
    assert shifted.data_ptr() % 16 == 4
    assert vl.layer_gemm_plan(shifted, torch.zeros((384, 96))) is None
    odd_k = torch.zeros((196, 26))            # 104-byte rows
    assert vl.layer_gemm_plan(odd_k, torch.zeros((26, 96))) is None


def test_the_layer_group_keeps_the_mma_sync_tile():
    src = (_CSRC / "vita_layer_group.cu").read_text()
    assert "mma_gemm.cuh" in src or "mma_gemm_tile" in src
    assert "gemm_wgmma" not in src
    assert "gemm_wgmma" not in (_CSRC / "mma_gemm.cuh").read_text()


def _tf32_bits(x):
    return (x.view(torch.int32) + 0x1000) & -0x2000


def test_split_planes_are_the_kernels_tf32_parts():
    g = torch.Generator().manual_seed(0)
    w = torch.randn((40, 24), generator=g) * 3.0
    hi, lo = vl.split_planes(w)
    assert hi.shape == lo.shape == (24, 40)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi.view(torch.int32), _tf32_bits(w.t().contiguous()))
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all(lo.view(torch.int32) & 0x1FFF == 0)
    # hi + lo holds w to 2^-22 of its magnitude
    err = (hi.double() + lo.double() - w.t().double()).abs()
    assert torch.all(err <= w.t().double().abs() * 2.0 ** -21)


def test_weight_planes_are_remade_after_an_in_place_update():
    w = torch.randn((16, 8))
    hi, lo = vl.weight_planes(w)
    again = vl.weight_planes(w)
    assert again[0] is hi and again[1] is lo
    with torch.no_grad():
        w.add_(1.0)
    hi2, lo2 = vl.weight_planes(w)
    assert hi2 is not hi
    ref_hi, ref_lo = vl.split_planes(w)
    assert torch.equal(hi2, ref_hi) and torch.equal(lo2, ref_lo)


def test_weight_planes_drop_with_the_weight():
    w = torch.randn((16, 8))
    hi = weakref.ref(vl.weight_planes(w)[0])
    assert id(w) in vl._PLANES and hi() is not None
    del w
    gc.collect()
    assert hi() is None


def test_planes_of_a_weight_that_wants_a_gradient_carry_none():
    w = torch.randn((16, 8), requires_grad=True)
    hi, lo = vl.weight_planes(w)
    assert not hi.requires_grad and not lo.requires_grad


@pytest.fixture
def stubbed(monkeypatch):
    """The launches with the card stubbed out: checks, the stream, the SM
    count and `build.call` (recorded)."""
    calls = []
    monkeypatch.setattr(vl, "check", lambda *a, **k: None)
    monkeypatch.setattr(vl, "stream", lambda: 0)
    monkeypatch.setattr(vl, "sm_count", lambda index: vl.H100_SMS)
    monkeypatch.setattr(build, "call", lambda *a, **k: calls.append(a[1]))
    trace.disable()
    trace.reset()
    try:
        yield calls
    finally:
        trace.disable()
        trace.reset()


_COUNTERS = ("kernels.gemm_macs", "kernels.gemm_wgmma_macs",
             "kernels.gemm_tile_macs")


def _counts():
    c = trace.counters()
    return tuple(c[k] for k in _COUNTERS)


def test_launch_layer_gemm_counts_its_products(stubbed):
    a = torch.zeros((196, 384))
    w = torch.zeros((384, 1536))
    wb = torch.zeros((384, 1536), dtype=torch.bfloat16)
    out = torch.empty((196, 1536))
    vl.launch_layer_gemm(a, w, out, gelu=True)
    assert _counts() == (0, 0, 0)
    trace.enable(cap=100)
    vl.launch_layer_gemm(a, w, out, gelu=True)
    vl.launch_layer_gemm(a, wb, out, gelu=True)
    trace.disable()
    assert stubbed == ["rt_gemm_wgmma", "rt_gemm_wgmma", "rt_mma_gemm"]
    plan = vl.gemm_wgmma_plan(196, 1536, 384)
    macs = 196 * 1536 * 384
    tile = plan.tiles * plan.bm * plan.bn * 384
    assert _counts() == (2 * macs, macs, tile)
    assert tile > macs            # the padding rows of the last tiles


def test_the_tile_counter_counts_k_padding(stubbed):
    a = torch.zeros((100, 24))
    w = torch.zeros((24, 24))
    trace.enable(cap=100)
    vl.launch_layer_gemm(a, w, torch.empty((100, 24)))
    trace.disable()
    plan = vl.gemm_wgmma_plan(100, 24, 24)
    assert _counts() == (100 * 24 * 24, 100 * 24 * 24,
                         plan.tiles * plan.bm * plan.bn * vl.WG_BK)
