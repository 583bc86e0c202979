"""The MSA tile's launch plan (`kernels/vita_msa.py::msa_plan`) on the CPU:
every shape the registry serves gets a cluster of at most 8 blocks whose
row slices cover N exactly, within one H100 block's shared memory
(232,448 bytes), in each dtype mode; every Dh up to 128 at N up to 577
gets a plan, paged (the projection alone, then the attention tile) where
K and V do not fit the cluster's blocks; shapes past the tiles raise.

The packed tile's plan (`msa_packed_plan`): a layout exactly for fp32 z,
N and Dh up to 32 and buffers within two blocks an SM (TNT-S's and
TNT-B's pixel streams in fp32 and mixed; never bf16 z, DeiT-S, Swin-T or
TNT-S's outer stream), whole sequences of at most 64 rows a block, its
buffers apart; and `msa_plan` returns for every shape the plan it
returned before the packed tile existed."""

import hashlib

import pytest

from repro_torch.kernels.build import SMEM_LIMIT, TWO_BLOCK_SMEM
from repro_torch.kernels.vita_msa import (MsaPlan, attention_plan,
                                          msa_packed_plan, msa_plan)
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


def _served_calls():
    """(model, N, D, H, Dh) of every MSA call the registry's models make,
    at full and reduced size (`_served_shapes` with the widths)."""
    out = set()
    for name in vision_registry.list_models():
        for full in (True, False):
            cfg = vision_registry.build_cfg(name, full=full)
            if hasattr(cfg, "depths"):
                for s in range(len(cfg.depths)):
                    d = cfg.stage_dim(s)
                    out.add((name, cfg.window ** 2, d, cfg.heads[s],
                             d // cfg.heads[s]))
            else:
                out.add((name, cfg.tokens, cfg.dim, cfg.heads,
                         cfg.head_dim))
            if hasattr(cfg, "inner_tokens"):
                out.add((name, cfg.inner_tokens, cfg.inner_dim,
                         cfg.inner_heads, cfg.inner_head_dim))
    return sorted(out)


def _least_bytes(n, d, h, dh, w_size):
    """The packed tile's buffers without any padding: z and the weights,
    or SA's staging over them, then Q, K and V."""
    rows = 64 // n * n
    return (max(rows * d * 4 + d * 3 * h * dh * w_size, rows * h * dh * 4)
            + rows * 3 * h * dh * 4)


def _packed_ok(p, n, d, h, dh, w_size):
    """The layout's invariants: whole sequences, at most 64 rows a block;
    D and Dh padded to the MMA's 8, the product's columns to 16; z, the
    weights, SA's staging and Q, K, V apart within two blocks an SM; Q, K
    and V rows for every row the last sequence's query slices read."""
    rm = -(-p.rows // 16) * 16
    assert p.seqs == 64 // n and p.rows == p.seqs * n <= 64
    assert p.seqs >= 2
    assert p.kp == -(-d // 8) * 8 and p.dp == -(-dh // 8) * 8
    assert p.cols == -(-3 * h * p.dp // 16) * 16
    assert p.ldz >= p.kp and p.ldz % 32 in (8, 24)
    assert p.ldq >= p.cols and p.ldq % 32 in (8, 24)
    assert p.ldw >= p.cols
    assert p.ldw % 16 == 4 if w_size == 4 else p.ldw % 32 in (8, 24)
    assert p.qrows >= rm and p.qrows >= (p.seqs - 1) * n + -(-n // 16) * 16
    assert p.w_off >= rm * p.ldz * 4 and p.w_off % 16 == 0
    assert p.qkv_off >= p.w_off + p.kp * p.ldw * w_size
    assert p.qkv_off >= p.rows * h * dh * 4 and p.qkv_off % 16 == 0
    assert p.qkv_off + p.qrows * p.ldq * 4 <= p.smem <= TWO_BLOCK_SMEM
    assert p.smem >= _least_bytes(n, d, h, dh, w_size)


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("model,n,d,h,dh", _served_calls())
def test_served_shapes_take_the_packed_tile_where_the_rule_says(
        model, n, d, h, dh, z_size, w_size):
    """fp32 z, N and Dh up to 32 and a layout within two blocks an SM:
    the packed tile; anything else: the cluster tile, whose plan is the
    one `msa_plan` gives.  Of the registry's short shapes only ViT-edge's
    and reduced TNT's outer stream (N 16, D 96, 4 heads of 24) do not fit
    two blocks an SM, even unpadded."""
    p = msa_packed_plan(n, d, h, dh, z_size, w_size)
    short = z_size == 4 and n <= 32 and dh <= 32
    if p is not None:
        assert short
        _packed_ok(p, n, d, h, dh, w_size)
    elif short:
        assert (n, d, h, dh) == (16, 96, 4, 24)
        assert _least_bytes(n, d, h, dh, w_size) > TWO_BLOCK_SMEM
    assert msa_plan(n, dh, z_size, w_size).smem <= SMEM_LIMIT


@pytest.mark.parametrize("z_size,w_size", _SIZES)
def test_tnt_streams_and_deit_swin_routes(z_size, w_size):
    """TNT-S's pixel stream (N 16, D 24, 4 heads of 6) and TNT-B's
    published one (N 16, D 40, 4 heads of 10) pack four sequences a block
    with fp32 z, and take the cluster tile with bf16 z; DeiT-S and TNT-S's
    outer stream (N 196, D 384, 6 heads of 64) and Swin-T's windows (N 49)
    never pack."""
    for n, d, h, dh in ((16, 24, 4, 6), (16, 40, 4, 10)):
        p = msa_packed_plan(n, d, h, dh, z_size, w_size)
        if z_size == 2:
            assert p is None
        else:
            _packed_ok(p, n, d, h, dh, w_size)
            assert (p.seqs, p.rows, p.qrows) == (4, 64, 64)
    tnt_s = msa_packed_plan(16, 24, 4, 6, z_size, w_size)
    if z_size == 4:
        assert (tnt_s.dp, tnt_s.cols, tnt_s.smem) == (
            (8, 96, 42368) if w_size == 4 else (8, 96, 37760))
    for n, d, h, dh in ((196, 384, 6, 64), (49, 96, 3, 32),
                        (49, 768, 24, 32)):
        assert msa_packed_plan(n, d, h, dh, z_size, w_size) is None


@pytest.mark.parametrize("w_size", [4, 2])
@pytest.mark.parametrize("n,d,h,dh,packed", [
    (1, 24, 4, 6, (1, 1)), (7, 24, 4, 6, (1, 1)), (17, 24, 4, 6, (1, 1)),
    (32, 24, 4, 6, (1, 1)), (33, 24, 4, 6, (0, 0)),
    (16, 32, 1, 32, (1, 1)), (32, 32, 1, 32, (1, 1)),
    (16, 33, 1, 33, (0, 0)), (16, 64, 2, 32, (0, 1)),
    (32, 64, 2, 32, (0, 1)), (16, 96, 4, 24, (0, 0)),
    (16, 384, 6, 64, (0, 0))])
def test_packed_plan_edges(n, d, h, dh, packed, w_size):
    """N 1, 7, 17 and 32 pack (64, 9, 3 and 2 sequences a block), N 33
    does not; Dh 32 packs where the buffers fit two blocks an SM (with
    bf16 weights at D 64, 2 heads; with fp32 ones W's 50 KB do not), Dh
    33 never."""
    p = msa_packed_plan(n, d, h, dh, 4, w_size)
    assert (p is not None) == bool(packed[w_size == 2])
    if p is not None:
        _packed_ok(p, n, d, h, dh, w_size)
        assert p.seqs == {1: 64, 7: 9, 17: 3, 32: 2}.get(n, 4)


@pytest.mark.parametrize("b", [1, 3, 4, 1568, 1570, 6272])
def test_packed_blocks_cover_a_ragged_batch(b):
    """ceil(B / G) blocks of G sequences cover B, the last one ragged by
    fewer than G sequences (what `kernels.msa_tile_rows` counts)."""
    p = msa_packed_plan(16, 24, 4, 6)
    blocks = -(-b // p.seqs)
    assert (blocks - 1) * p.seqs < b <= blocks * p.seqs
    assert blocks * p.rows - b * 16 < p.rows


# msa_plan's fields at the registry's main shapes, and a digest of every
# plan over N 1-69 and the served sizes past it, Dh 1-128, each dtype mode
# (None where it raises), as they were before the packed tile.
_PLANS = {(16, 6): MsaPlan(32, 64, 1, 16, 40, 23040, 3, 0, 10240, 20480,
                           29696, 34816, 10240, 79360, 0),
          (196, 64): MsaPlan(64, 64, 4, 208, 232, 35328, 4, 0, 18432,
                             92160, 161792, 191488, 18432, 191488, 0),
          (49, 32): MsaPlan(32, 64, 1, 64, 72, 23040, 3, 0, 10240, 20480,
                            29696, 38912, 10240, 79360, 0)}
_PLAN_DIGEST = ("e287817e66628c55eaf088196aac9241f01b5d8f43ed5ef0c289478a1f42"
                "d91d")


def test_msa_plan_is_unchanged():
    for (n, dh), want in _PLANS.items():
        assert msa_plan(n, dh, 4, 4) == want
    h = hashlib.sha256()
    for zs, ws in _SIZES:
        for dh in range(1, 129):
            for n in list(range(1, 70)) + [196, 197, 256, 257, 512, 513,
                                           576, 577, 704]:
                try:
                    p = tuple(msa_plan(n, dh, zs, ws))
                except ValueError:
                    p = None
                h.update(repr((n, dh, zs, ws, p)).encode())
    assert h.hexdigest() == _PLAN_DIGEST

