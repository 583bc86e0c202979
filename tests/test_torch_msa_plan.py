"""The MSA tile's launch plan (`kernels/vita_msa.py::msa_plan`) on the CPU:
every shape the registry serves gets a cluster of at most 8 blocks whose
row slices cover N exactly, within one H100 block's shared memory
(232,448 bytes), in each dtype mode; every Dh up to 128 at N up to 577
gets a plan, paged (the projection alone, then the attention tile) where
K and V do not fit the cluster's blocks; shapes past the tiles raise."""

import pytest

from repro_torch.kernels.vita_msa import (SMEM_LIMIT, attention_plan,
                                          msa_plan)
from repro_torch.models import vision_registry

# (z bytes, weight bytes) of the three dtype modes: fp32, mixed, bf16.
_SIZES = ((4, 4), (4, 2), (2, 2))


def _served_shapes():
    """(model, N, Dh) of every MSA call the registry's models make, at
    full and reduced size: a ViT's tokens, a Swin stage's window, TNT's
    outer tokens and its pixel tokens."""
    out = set()
    for name in vision_registry.list_models():
        for full in (True, False):
            cfg = vision_registry.build_cfg(name, full=full)
            if hasattr(cfg, "depths"):
                for s in range(len(cfg.depths)):
                    out.add((name, cfg.window ** 2,
                             cfg.stage_dim(s) // cfg.heads[s]))
            else:
                out.add((name, cfg.tokens, cfg.head_dim))
            if hasattr(cfg, "inner_tokens"):
                out.add((name, cfg.inner_tokens, cfg.inner_head_dim))
    return sorted(out)


def test_served_shapes_cover_the_registry():
    models = {m for m, _, _ in _served_shapes()}
    assert {"deit_t", "deit_t_p", "swin_t", "swin_t_p", "vit_edge",
            "vit_edge_p"} <= models
    assert ("deit_t", 196, 64) in _served_shapes()
    assert ("vit_edge", 256, 64) in _served_shapes()      # ViT-B/16 widths
    assert ("swin_t", 49, 32) in _served_shapes()
    assert {("tnt_s", 196, 64), ("tnt_s", 16, 6)} <= set(_served_shapes())


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("model,n,dh", _served_shapes())
def test_every_served_shape_has_a_plan(model, n, dh, z_size, w_size):
    plan = msa_plan(n, dh, z_size, w_size)
    assert plan.smem <= SMEM_LIMIT
    assert 1 <= plan.cluster <= 8 and plan.rows == 64
    assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
    assert plan.dp >= dh and plan.dp % 32 == 0


@pytest.mark.parametrize("z_size,w_size", _SIZES)
def test_slices_cover_n_exactly_up_to_the_widest(z_size, w_size):
    """From 1 token to the widest N the plan admits, the 64-row slices
    tile N with one ragged last slice, one block each."""
    widest = 0
    for n in range(1, 513):
        try:
            plan = msa_plan(n, 32, z_size, w_size)
        except ValueError:
            continue
        widest = n
        assert plan.cluster <= 8
        assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
        assert plan.cluster == -(-n // 64)
    assert widest > 256


def test_unplannable_shapes_raise():
    with pytest.raises(ValueError):
        msa_plan(196, 129)                # Dh past the tiles' 128
    with pytest.raises(ValueError):
        msa_plan(1473, 32)                # the paged scores past 227 KB
    with pytest.raises(ValueError):
        msa_plan(705, 128, 4, 4)          # past N 704 at Dh 128


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("n,dh", [(17, 24), (49, 32), (65, 64), (196, 64),
                                  (256, 64), (480, 32)])
def test_plan_buffers_lie_apart_within_the_block(n, dh, z_size, w_size):
    """The layout the launch takes as is: Q, K, V (z's type), the scores
    and, in the bf16 mode, bf16 P lie in that order without overlap; the
    projection's ring starts after Q, holds a z tile and a weight tile a
    stage and ends within the block's shared memory."""
    p = msa_plan(n, dh, z_size, w_size)
    rows, ldv = p.cluster * p.rows, p.dp + (4 if z_size == 4 else 8)
    assert p.nk >= n and p.nk % 16 == 0 and p.lds >= p.nk
    assert p.q_off + p.rows * (p.dp + 8) * 4 <= p.k_off
    assert p.k_off + rows * (p.dp + 8) * 4 <= p.v_off
    assert p.v_off + rows * ldv * z_size <= p.s_off
    assert p.s_off + 32 * p.lds * 4 <= p.p_off
    assert p.p_off + (32 * (p.nk + 8) * 2 if z_size == 2 else 0) <= p.smem
    kc = 32 if z_size == 4 else 64
    ldw = 3 * p.dp + (4 if w_size == 4 else 8)
    assert p.stage >= p.rows * (kc + 8) * z_size + kc * ldw * w_size
    assert p.ring_off >= p.k_off and 3 <= p.stages <= 8
    assert p.ring_off + p.stages * p.stage <= p.smem <= SMEM_LIMIT


# (N, Dh) past the cluster tile: wide heads at ViT-B's N, ViT-B/16 at 384
# px (N 576 patches, 577 with the class token), fp32 N past 256 at Dh 64,
# and N past 8 slices of 64.
_PAGED = [(197, 96), (197, 128), (576, 64), (577, 64), (576, 128),
          (577, 128), (257, 64), (513, 32)]


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("n,dh", _PAGED)
def test_paged_plans_past_the_cluster(n, dh, z_size, w_size):
    """Where K and V of all N rows do not fit one block beside Q and the
    scores, the plan is paged: one projection block per 64-row slice at
    DP 64 or 128, its ring at offset 0 holding a z tile and the weight
    slices of a pass (three side by side at DP 64, one at DP 128) a stage,
    3-8 stages, within the block's shared memory, which also holds the
    attention tile's layout for (N, Dh)."""
    p = msa_plan(n, dh, z_size, w_size)
    if (n, dh) == (257, 64) and z_size == 2:
        assert p.paged == 0               # bf16 V fits N 257 in a cluster
        return
    assert p.paged == 1
    assert p.dp == (64 if dh <= 64 else 128) and p.rows == 64
    assert p.cluster == -(-n // 64)
    assert p.ring_off == 0 and (p.nk, p.lds, p.q_off, p.k_off) == (0,) * 4
    kc = 32 if z_size == 4 else 64
    parts = 3 if p.dp == 64 else 1
    ldw = parts * p.dp + (4 if w_size == 4 else 8)
    assert p.stage == 64 * (kc + 8) * z_size + kc * ldw * w_size
    assert 3 <= p.stages <= 8
    att = attention_plan(n, dh)
    assert p.smem == max(p.stages * p.stage, att.smem) <= SMEM_LIMIT
    if p.stages < 8:
        assert (p.stages + 1) * p.stage > att.smem or p.stages == 3


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("dh", [1, 24, 32, 33, 48, 64, 65, 80, 96, 100,
                                127, 128])
def test_every_dh_up_to_128_takes_n_up_to_577(dh, z_size, w_size):
    """Dh 1-128 at N 1 to 577: a plan in every mode, a cluster one exactly
    where Dh is at most 64, N at most 512 and the cluster layout fits."""
    for n in (1, 17, 49, 64, 65, 196, 197, 256, 257, 384, 512, 513, 576,
              577):
        p = msa_plan(n, dh, z_size, w_size)
        assert p.dp >= dh and p.cluster == -(-n // 64)
        assert p.smem <= SMEM_LIMIT
        if dh > 64 or n > 512:
            assert p.paged == 1
        if p.paged == 0:
            assert p.cluster <= 8 and p.dp <= 64 and p.nk >= n


def _conflict_free_pairs(ld):
    """8-byte loads of a weight row pair: lane 4 g + t reads row 2 t + s
    at columns 2 g, 2 g + 1 (word address (2 t + s) ld + 2 g); each half
    warp's 32 words fall on 32 distinct banks."""
    for s in (0, 1):
        words = [(2 * (l % 4) + s) * ld + 2 * (l // 4) for l in range(32)]
        for half in (words[:16], words[16:]):
            if len({b % 32 for a in half for b in (a, a + 1)}) != 32:
                return False
    return True


@pytest.mark.parametrize("w_size", [4, 2])
def test_dp_128_weight_rows_hit_distinct_banks(w_size):
    """The projection's weight stage at DP 128 (one slice a pass): fp32
    rows of 132 floats feed the split-TF32 pair loads without conflicts;
    bf16 rows of 136 values are 272 bytes, so the eight 16-byte row
    addresses of an ldmatrix phase fall on eight distinct 4-bank groups."""
    if w_size == 4:
        assert _conflict_free_pairs(128 + 4)
        assert not _conflict_free_pairs(128)
    else:
        row_words = (128 + 8) * 2 // 4
        assert len({(r * row_words) % 32 // 4 for r in range(8)}) == 8


@pytest.mark.parametrize("model_axis", [2, 3, 4])
def test_local_shard_shapes_have_plans(model_axis):
    """On a model-axis mesh every rank runs the layer's kernels on its
    shards (`distributed.sharding`'s rules: heads split where they divide,
    the concat rows with them, the MLP columns where the hidden width
    divides): every served layer's local MSA and attention tiles, and its
    four int8 GEMMs (QKV per-head stacks, concat, up, down) at their
    local widths, get plans."""
    from repro_torch.kernels.int8_matmul import I8_KGROUPS, gemm_i8_plan

    from test_torch_group_plan import _served_group_shapes

    for model, b, n, d, h, dh, m in _served_group_shapes():
        h_l = h // model_axis if h % model_axis == 0 else h
        m_l = m // model_axis if m % model_axis == 0 else m
        for z_size, w_size in _SIZES:
            assert msa_plan(n, dh, z_size, w_size).smem <= SMEM_LIMIT
        assert attention_plan(n, dh).smem <= SMEM_LIMIT
        rows = b * n
        for cols, k, ldb, grp, stride in (
                (h_l * dh, d, dh, dh, d * dh),       # Q / K / V stacks
                (d, h_l * dh, d, d, 0),              # concat
                (m_l, d, m_l, m_l, 0),               # up
                (d, m_l, d, d, 0)):                  # down
            plan = gemm_i8_plan(rows, cols, k, ldb=ldb, grp=grp,
                                grp_stride=stride)
            assert plan.kgroups in I8_KGROUPS, (model, cols, k)
            assert plan.a_chunk in (16, 8, 4, 1)
            assert plan.b_chunk in (16, 8, 4, 1)
            assert plan.tiles == -(-rows // 64) * -(-cols // 64)
