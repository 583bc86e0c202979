"""The attention tile's launch plan (`kernels/vita_msa.py::attention_plan`)
on the CPU.  The tile (csrc/attention.cuh) runs the attention of the int8
chains: kernel 2's and kernel 3's launch and kernel 8's attention stage.

Every shape the registry serves fits two 256-thread blocks an SM (kernel
8 holds two blocks an SM beside its 68 KB GEMM rings); the rows are padded
so that each fragment load the tile makes falls on distinct banks; every
Dh up to 128 (padded to 32, 64 or 128) and every N up to the old
warp-per-row tile's limit at Dh 64 (420) gets a plan, whose buffers lie
apart within one block's shared memory; N runs to 1,216 at Dh 64 and to
704 at Dh 128 (577, ViT-B/16 at 384 px, included); shapes past the tile
raise ValueError."""

import pytest

from repro_torch.kernels.build import SMEM_LIMIT, TWO_BLOCK_SMEM
from repro_torch.kernels.vita_layer_group import (INT8_GROUP_RING,
                                                  int8_group_plan)
from repro_torch.kernels.vita_msa import attention_plan

from test_torch_group_plan import _served_group_shapes

# An SM's shared memory (H100) and what the card keeps for each block.
_SM_SMEM, _RESERVED = 233472, 1024


def _served():
    """(model, N, Dh) of every attention the registry's models serve."""
    return sorted({(s[0], s[2], s[5]) for s in _served_group_shapes()})


def test_served_shapes_cover_deit_swin_and_the_pruned():
    shapes = _served()
    assert {"deit_t", "deit_t_p", "swin_t", "swin_t_p", "vit_edge",
            "vit_edge_p"} <= {s[0] for s in shapes}
    assert ("deit_t", 196, 64) in shapes and ("swin_t", 49, 32) in shapes


@pytest.mark.parametrize("model,n,dh", _served())
def test_every_served_shape_fits_two_blocks_an_sm(model, n, dh):
    p = attention_plan(n, dh)
    assert 2 * (p.smem + _RESERVED) <= _SM_SMEM
    assert p.smem <= TWO_BLOCK_SMEM == _SM_SMEM // 2 - _RESERVED
    assert p.stages == 3


@pytest.mark.parametrize("model,b,n,d,h,dh,m", [
    s for s in _served_group_shapes() if s[1] == 8])
def test_int8_group_keeps_two_blocks_an_sm(model, b, n, d, h, dh, m):
    """Kernel 8's shared memory is the larger of its GEMM rings and the
    tile's layout, and two such blocks fit an SM at every served shape
    (DeiT-T, Swin-T stages 1-4, the pruned variants)."""
    p = int8_group_plan(b, n, d, h, dh, m, 132, 2)
    assert p.att == attention_plan(n, dh)
    assert p.smem == max(INT8_GROUP_RING, p.att.smem)
    assert 2 * (p.smem + _RESERVED) <= _SM_SMEM


def _banks(addr_words):
    """The 32-bit banks an 8-byte load touches from each word address."""
    return [b for a in addr_words for b in (a % 32, (a + 1) % 32)]


def _conflict_free(addr_words):
    """An 8-byte load of a warp is served as two half-warps of 16 lanes:
    each half's 32 words must fall on 32 distinct banks."""
    return all(len(set(_banks(addr_words[i:i + 16]))) == 32
               for i in (0, 16))


@pytest.mark.parametrize("n,dh", [(49, 32), (196, 64), (197, 64),
                                  (257, 32), (400, 64), (1216, 64),
                                  (197, 96), (197, 128), (576, 64),
                                  (577, 64), (576, 128), (577, 128)])
def test_rows_are_padded_to_distinct_banks(n, dh):
    """Lane l = 4 g + t of a warp: an A fragment (Q's parts, or P in the
    scores) reads rows g at columns 2t, 2t + 1; a K fragment key rows g at
    columns 2t, 2t + 1; a B pair of V rows 2t at columns 2g, 2g + 1; a
    score pair is stored at row g, columns 2t, 2t + 1."""
    p = attention_plan(n, dh)
    lanes = [(l // 4, l % 4) for l in range(32)]
    for ld in (p.ldk, p.lds):           # Q, K pages, scores (load / store)
        assert _conflict_free([g * ld + 2 * t for g, t in lanes])
    assert _conflict_free([2 * t * p.ldv + 2 * g for g, t in lanes])
    assert _conflict_free([(2 * t + 1) * p.ldv + 2 * g for g, t in lanes])


@pytest.mark.parametrize("dh", range(1, 129))
def test_every_dh_up_to_64_takes_n_up_to_the_old_limit(dh):
    """Dh 1-128 (padded to 32, 64 or 128) at N 1 to 420, the most the
    warp-per-row tile took at Dh 64: a plan whose pages cover N, whose
    buffers lie apart in that order within one block, with a ring slot
    that holds a K page (and so a V page)."""
    for n in (1, 7, 49, 63, 64, 65, 196, 197, 256, 257, 333, 420):
        p = attention_plan(n, dh)
        assert p.dp == (32 if dh <= 32 else 64 if dh <= 64 else 128)
        assert p.rows == 32
        assert p.nk % 64 == 0 and p.nk - 64 < n <= p.nk
        assert (p.ldk, p.ldv, p.lds) == (p.dp + 8, p.dp + 4, p.nk + 8)
        # Q's TF32 parts (hi, lo) and the rows' maxima and reciprocal
        # sums, then the scores, which also carry P.V's partial sums (DP
        # 32: four key groups, DP 64: two, DP 128: one, none to carry).
        red = (8 // (p.dp // 16) - 1) * 16 * (p.dp // 16) * 32
        assert p.q_off == 0 and p.s_off == 2 * p.rows * (p.ldk + 1) * 4
        assert p.ring_off == p.s_off + max(p.rows * p.lds, red) * 4
        assert p.stage == 64 * p.ldk * 4 >= 64 * p.ldv * 4
        assert p.stages in (2, 3)
        assert p.smem == p.ring_off + p.stages * p.stage <= SMEM_LIMIT
        # Two ring slots only where two blocks an SM need them.
        if p.stages == 2:
            assert p.smem + p.stage > TWO_BLOCK_SMEM


def test_n_runs_to_the_block_limit():
    """The widest N at Dh 64 is 1,216 (one block an SM, three slots) and
    at Dh 32 1,472; two blocks an SM hold up to N 448 at Dh 64 (three
    slots up to 256, two past it)."""
    assert attention_plan(1216, 64).smem <= SMEM_LIMIT
    assert attention_plan(1472, 32).smem <= SMEM_LIMIT
    assert attention_plan(256, 64).stages == 3
    assert attention_plan(257, 64).stages == 2
    assert attention_plan(448, 64).smem <= TWO_BLOCK_SMEM
    assert attention_plan(449, 64).smem > TWO_BLOCK_SMEM


@pytest.mark.parametrize("n,dh", [(196, 129), (196, 160), (196, 0), (0, 64),
                                  (1217, 64), (1473, 32), (705, 128)])
def test_shapes_past_the_tile_raise(n, dh):
    with pytest.raises(ValueError):
        attention_plan(n, dh)


@pytest.mark.parametrize("n,dh", [(197, 96), (197, 128), (576, 64),
                                  (577, 64), (576, 128), (577, 128),
                                  (704, 128)])
def test_wide_heads_and_384_px_fit_one_block(n, dh):
    """Dh 96 and 128 at ViT-B's N 197, and ViT-B/16 at 384 px (N 576 and
    577) at Dh 64 and 128: Q's parts, the scores and three ring slots lie
    apart within one block; at DP 128 one block an SM (the eight warps
    are the eight column blocks of P.V, so no partial sums)."""
    p = attention_plan(n, dh)
    assert p.nk - 64 < n <= p.nk and p.lds == p.nk + 8
    assert p.s_off == 2 * p.rows * (p.ldk + 1) * 4
    assert p.ring_off == p.s_off + p.rows * p.lds * 4
    assert p.smem == p.ring_off + p.stages * p.stage <= SMEM_LIMIT
    if p.dp == 128:
        assert p.stages == 3 and p.smem > TWO_BLOCK_SMEM
        assert p.stage == 64 * 136 * 4


def test_int8_group_takes_dh_128_at_one_block_an_sm():
    """Kernel 8 at a ViT-B geometry of 6 heads of 128: its shared memory
    is the attention tile's layout (larger than its GEMM rings), one block
    an SM; at Dh 64 it keeps two."""
    wide = int8_group_plan(2, 197, 768, 6, 128, 3072, 132, 1)
    assert wide.att == attention_plan(197, 128)
    assert wide.smem == wide.att.smem > TWO_BLOCK_SMEM
    narrow = int8_group_plan(2, 197, 768, 12, 64, 3072, 132, 2)
    assert 2 * (narrow.smem + _RESERVED) <= _SM_SMEM
