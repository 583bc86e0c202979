"""The launch plans of the float layer group's kernel
(`kernels/vita_layer_group.py::group_plan`) and of the int8 GEMM
(`kernels/int8_matmul.py::gemm_i8_plan`) on the CPU.

For every (N, Dh, D, M) and surviving head count the registry serves, at
full and reduced size, batch 1 and 8, and in each dtype mode: each stage's
tiles cover its output exactly, the shared memory fits one H100 block
(232,448 bytes) and holds both the MSA tile's layout and the GEMM tile's
ring, the grid is no larger than the widest stage's work, and the group
plan refuses exactly the shapes the MSA tile's plan refuses.  The int8
plan copies 16-byte chunks of B only where a chunk stays inside one head
and is aligned, and splits a tile's k steps over two warp groups only
where the tiles leave SMs idle."""

import pytest

from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.int8_matmul import I8_TILE, b_layout, gemm_i8_plan
from repro_torch.kernels.vita_layer_group import GroupPlan, group_plan
from repro_torch.kernels.vita_msa import attention_plan, msa_plan
from repro_torch.models import vision_registry

# Weight bytes of the three dtype modes (the group's z is fp32 in each):
# fp32, mixed (fp32 activations, bf16 weights), bf16.
_MODES = {"fp32": 4, "mixed": 2, "bf16": 2}


def _served_group_shapes():
    """(model, B, N, D, H, Dh, M) of every layer the registry's models
    serve at buckets 1 and 8, at full and reduced size: a ViT's tokens, a
    Swin stage's windows folded into the batch, TNT's pixel tokens with
    the patches folded into the batch; H every surviving head count of a
    pruned variant."""
    out = set()
    for name in vision_registry.list_models():
        for full in (True, False):
            cfg = vision_registry.build_cfg(name, full=full)
            if hasattr(cfg, "depths"):
                for s, depth in enumerate(cfg.depths):
                    d, heads = cfg.stage_dim(s), cfg.heads[s]
                    n_w = (cfg.stage_side(s) // cfg.window) ** 2
                    mask = cfg.stage_mask(s) or [(1,) * heads] * depth
                    for bucket in (1, 8):
                        for row in mask:
                            out.add((name, bucket * n_w, cfg.window ** 2, d,
                                     sum(row), d // heads,
                                     int(d * cfg.mlp_ratio)))
            else:
                mask = cfg.head_mask or [(1,) * cfg.heads]
                for bucket in (1, 8):
                    for row in mask:
                        out.add((name, bucket, cfg.tokens, cfg.dim, sum(row),
                                 cfg.head_dim, int(cfg.dim * cfg.mlp_ratio)))
            if hasattr(cfg, "inner_tokens"):
                for bucket in (1, 8):
                    out.add((name, bucket * cfg.tokens, cfg.inner_tokens,
                             cfg.inner_dim, cfg.inner_heads,
                             cfg.inner_head_dim, cfg.inner_mlp_hidden))
    return sorted(out)


def test_served_group_shapes_cover_the_registry():
    shapes = _served_group_shapes()
    assert {s[0] for s in shapes} >= {"deit_t", "deit_t_p", "swin_t",
                                      "swin_t_p", "vit_edge", "vit_edge_p"}
    assert ("deit_t", 8, 196, 192, 3, 64, 768) in shapes
    assert ("deit_t_p", 8, 196, 192, 1, 64, 768) in shapes
    assert ("swin_t", 8, 49, 768, 24, 32, 3072) in shapes
    assert ("tnt_s", 1568, 16, 24, 4, 6, 96) in shapes


def _ring_bytes(w_size):
    """The GEMM tile's ring (csrc/mma_gemm.cuh MgSmem)."""
    bk = 32 if w_size == 4 else 64
    return 4 * (32 * (bk + 8) * 4 + bk * (64 + (4 if w_size == 4 else 8))
                * w_size)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("model,b,n,d,h,dh,m", _served_group_shapes())
def test_every_served_group_has_a_plan_that_tiles_it(model, b, n, d, h, dh,
                                                     m, mode):
    w_size = _MODES[mode]
    p = group_plan(b, n, d, h, dh, m, w_size)
    assert isinstance(p, GroupPlan) and p.threads == 512
    assert p.msa == msa_plan(n, dh, 4, w_size)
    assert max(p.msa.smem, _ring_bytes(w_size)) == p.smem <= SMEM_LIMIT
    rows = b * n
    want = {"ln1": (rows, d), "qkv": (n, 3 * dh), "attention": (n, dh),
            "concat": (rows, d), "ln2": (rows, d), "up": (rows, m),
            "down": (rows, d)}
    assert [s.name for s in p.stages] == list(want)
    work = 0
    for s in p.stages:
        assert (s.out_rows, s.out_cols) == want[s.name]
        tiles_r, tiles_c = -(-s.out_rows // s.rows), -(-s.out_cols // s.cols)
        # Tiles cover the output exactly: the last row and column of tiles
        # reach past the edge by less than one tile.
        assert tiles_r * s.rows >= s.out_rows > (tiles_r - 1) * s.rows
        assert tiles_c * s.cols >= s.out_cols > (tiles_c - 1) * s.cols
        per_image = s.name in ("qkv", "attention")
        assert s.count == tiles_r * tiles_c * (b * h if per_image else 1)
        blocks = -(-s.count // 16) if s.rows == 1 else s.count
        work = max(work, blocks)
        assert s.waves == -(-blocks // p.grid)
    assert 1 <= p.grid == min(132, work)
    # The MSA stages run one 64-row slice a tile, as the tile's plan has it.
    assert p.stages[1].rows == p.msa.rows == 64
    assert p.stages[1].count == b * h * p.msa.cluster


def test_the_grid_follows_the_card_and_the_work():
    """DeiT-T batch 8 at one block an SM: 132 blocks, the D-wide GEMM
    stages in two waves (147 tiles of 32 x 64), the up product in five;
    a card holding two blocks an SM, and a one-image group with less work
    than the card, change only the grid and the waves."""
    p = group_plan(8, 196, 192, 3, 64, 768)
    stages = {s.name: s for s in p.stages}
    assert p.grid == 132 and stages["concat"].count == 147
    assert (stages["concat"].waves, stages["up"].waves) == (2, 5)
    assert stages["qkv"].count == stages["attention"].count == 96
    assert group_plan(8, 196, 192, 3, 64, 768, per_sm=2).grid == 264
    small = group_plan(1, 16, 96, 4, 24, 384)
    assert small.grid == max(s.count if s.rows > 1 else -(-s.count // 16)
                             for s in small.stages) < 132


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_group_plan_refuses_exactly_what_the_msa_tile_refuses(mode):
    """Every (N, Dh) from the smallest to past the tile's limits: the
    group plan raises ValueError exactly where `msa_plan` does, so the
    float layer and the float layer group serve the same shapes."""
    w_size = _MODES[mode]
    accepted = 0
    for dh in (8, 24, 32, 48, 64, 65, 80, 128, 129):
        for n in (1, 17, 49, 64, 65, 196, 256, 257, 300, 420, 480, 512,
                  513, 577, 704, 705, 1217):
            try:
                msa_plan(n, dh, 4, w_size)
                msa_ok = True
            except ValueError:
                msa_ok = False
            try:
                group_plan(2, n, 2 * dh, 2, dh, 4 * dh, w_size)
                group_ok = True
            except ValueError:
                group_ok = False
            assert msa_ok == group_ok, (n, dh)
            accepted += msa_ok
    assert accepted > 20


@pytest.mark.parametrize("align", [0, 4, 8])
def test_int8_b_chunks_stay_inside_one_head_and_aligned(align):
    """A per-head (H, K, Dh) stack read in place, Dh 1 to 96: B is copied
    in 16-byte chunks only where a chunk stays inside one head (Dh % 16 ==
    0) and every head and row starts aligned, else in the widest narrower
    chunk that does (8, 4 or 1 bytes)."""
    h, k = 3, 96
    for dh in range(1, 97):
        p = gemm_i8_plan(1568, h * dh, k, ldb=dh, grp=dh,
                         grp_stride=k * dh, b_align=align)
        assert (p.b_chunk == 16) == (dh % 16 == 0 and align == 0), dh
        assert dh % p.b_chunk == 0 and align % p.b_chunk == 0
        wider = [w for w in (16, 8, 4) if w > p.b_chunk]
        assert all(dh % w or align % w for w in wider), dh


def test_int8_a_chunks_follow_k_and_the_alignment():
    assert gemm_i8_plan(1568, 192, 768, ldb=192, grp=192,
                        grp_stride=0).a_chunk == 16
    assert gemm_i8_plan(37, 29, 53, ldb=29, grp=29, grp_stride=0).a_chunk \
        == 1
    assert gemm_i8_plan(97, 136, 200, ldb=136, grp=136,
                        grp_stride=0).a_chunk == 8
    assert gemm_i8_plan(64, 64, 64, ldb=64, grp=64, grp_stride=0,
                        a_align=4).a_chunk == 4


@pytest.mark.parametrize("m,n,k", [(1568, 192, 768), (8, 1000, 192),
                                   (1568, 768, 192), (1568, 192, 192),
                                   (25088, 96, 96), (392, 768, 3072),
                                   (37, 29, 53)])
def test_int8_k_groups_only_where_the_tiles_leave_sms_idle(m, n, k):
    """The 64 x 64 tile, its k steps split over two warp groups where the
    tiles number no more than the SMs and run by one warp group where
    they fill the card; its tiles cover (m, n)."""
    p = gemm_i8_plan(m, n, k, ldb=n, grp=n, grp_stride=0)
    tiles = -(-m // 64) * -(-n // 64)
    assert (p.bm, p.bn) == I8_TILE and p.tiles == tiles
    assert p.kgroups == (2 if tiles <= 132 else 1)
    assert p.waves == -(-tiles // 132) and p.stages == 4
    assert p.threads == 128 * p.kgroups
    assert p.smem == 4 * (64 * 144 + 128 * 64) <= SMEM_LIMIT
    assert p.launch_ints() == (64, 64, p.kgroups, 4, p.a_chunk, p.b_chunk)
    assert gemm_i8_plan(m, n, k, ldb=n, grp=n, grp_stride=0,
                        kgroups=1).kgroups == 1


def test_b_layout_of_a_stack_is_what_the_plan_reads():
    import torch
    w = torch.zeros((3, 96, 24), dtype=torch.int8)
    assert b_layout(w) == (96, 72, 24, 24, 96 * 24)
    with pytest.raises(ValueError):
        gemm_i8_plan(8, 64, 64, ldb=64, grp=64, grp_stride=0, kgroups=4)


@pytest.mark.parametrize("mode", sorted(_MODES))
@pytest.mark.parametrize("b,n,d,h,dh,m", [
    (2, 197, 768, 6, 128, 3072),          # ViT-B geometry, 6 heads of 128
    (2, 197, 768, 8, 96, 3072),
    (2, 577, 768, 12, 64, 3072),          # ViT-B/16 at 384 px
    (1, 300, 128, 2, 64, 256)])           # fp32 K and V past one block
def test_paged_group_plans_take_the_attention_tile(b, n, d, h, dh, m, mode):
    """Under a paged MSA plan the group's attention stage is the attention
    tile per (image, head, 32-query slice), its layout in the plan's ints
    after the MSA layout (29 ints), the block's shared memory holding the
    projection's ring, that layout and the GEMM ring; the plan runs on
    the paged plans' own kernel (kernel DP 0)."""
    w_size = _MODES[mode]
    p = group_plan(b, n, d, h, dh, m, w_size)
    assert p.msa.paged == 1 and p.kernel_dp == 0
    assert p.att == attention_plan(n, dh)
    st = {s.name: s for s in p.stages}
    assert st["attention"].rows == 32
    assert st["attention"].count == b * h * -(-n // 32)
    assert st["qkv"].count == b * h * -(-n // 64)
    assert p.smem == max(p.msa.smem, _ring_bytes(w_size)) <= SMEM_LIMIT
    assert p.smem >= p.att.smem and p.smem >= p.msa.stages * p.msa.stage
    ints = p.launch_ints()
    assert len(ints) == 29 and ints[15:27] == tuple(p.att)
    assert ints[27:] == (p.grid, p.smem)
