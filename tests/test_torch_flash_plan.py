"""The flash kernel's launch plan (`kernels/head_attention.py::flash_plan`)
on the CPU.

The keys each query tile walks cover exactly the (query, key) pairs a
brute-force causal / sliding-window / `q_offset` mask leaves visible: every
visible key of the tile's rows lies in its walk, the walk starts at the
first visible key rounded down to a whole key tile and ends after the last
one, and a tile whose rows see no key walks nothing.  Swept over Nq, Nk,
window and q_offset in both dtypes, with Nq <= 16 (16-row tiles), Nk <
Nq and a negative q_offset.  The layout fits one H100 block (232,448
bytes) at every head dim from 1 to 256, with the strides the tile's
fragment loads assume and, where warps share a group of 16 rows, the
partial scores they exchange."""

import numpy as np
import pytest

from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.head_attention import (FLASH_TILES, FlashPlan,
                                                flash_plan)

_CASES = [  # nq, nk, causal, window, q_offset
    (13, 13, True, 2048, 0), (4096, 4096, True, 2048, 0),
    (300, 300, True, 100, 0), (300, 300, False, 100, 0),
    (1, 1, True, None, 0), (16, 16, True, None, 0), (17, 17, True, None, 0),
    (5, 70, True, 16, 65), (3, 9, True, None, -4), (3, 9, False, None, -4),
    (40, 9, True, 5, -30), (64, 10, True, None, 0), (77, 77, True, None, 0),
    (150, 150, True, 40, 0), (150, 150, False, 40, 0),
    (129, 64, False, 7, 100),
    (70, 300, True, 33, 230), (200, 50, False, None, 0), (64, 64, True, 1, 0),
    (8, 200, False, 3, 500), (33, 100, True, 64, -20)]


def _visible(nq, nk, causal, window, q_offset):
    qpos = np.arange(nq)[:, None] + q_offset
    kpos = np.arange(nk)[None, :]
    vis = np.ones((nq, nk), dtype=bool)
    if causal:
        vis &= kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    return vis


@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("nq,nk,causal,window,q_offset", _CASES)
def test_walk_covers_exactly_the_visible_pairs(nq, nk, causal, window,
                                               q_offset, elem_size):
    p = flash_plan(2, 4, nq, nk, 80, elem_size, causal, window, q_offset)
    vis = _visible(nq, nk, causal, window, q_offset)
    assert p.grid == (4, -(-nq // p.rows), 2)
    assert p.rows == (16 if nq <= 16 else 64)          # Dh 80: the 128 class
    walked = np.zeros_like(vis)
    for tile in range(p.grid[1]):
        rows = slice(tile * p.rows, min(nq, (tile + 1) * p.rows))
        keys = np.nonzero(vis[rows].any(0))[0]
        kb, ke = p.walk(tile)
        if len(keys) == 0:
            assert ke <= kb, (tile, kb, ke)
            continue
        assert kb % p.bk == 0 and kb <= keys[0] < kb + p.bk, (tile, kb)
        assert ke == keys[-1] + 1, (tile, ke)
        walked[rows, kb:ke] = True
    # Every visible pair is walked, and what is walked beyond them is the
    # masked part of tiles the rows do see.
    assert np.all(walked[vis])
    assert p.keys_walked() >= int(vis.any(0).sum()) if vis.any() else True


@pytest.mark.parametrize("elem_size", [2, 4])
def test_layout_fits_one_block_at_every_head_dim(elem_size):
    for dh in range(1, 257):
        for nq in (13, 4096):
            p = flash_plan(1, 10, nq, nq, dh, elem_size)
            assert isinstance(p, FlashPlan)
            assert p.path == ("mma_bf16" if elem_size == 2 else "split_tf32")
            assert p.dp % 16 == 0 and dh <= p.dp < dh + 16 and p.dp <= p.dmax
            assert p.dmax == (128 if p.dp <= 128 else 256)
            bk, groups, nw = FLASH_TILES[(elem_size, p.dmax)][nq > 16]
            assert (p.bk, p.rows, p.nw) == (bk, 16 * groups, nw)
            if elem_size == 2:
                # rows of an odd count of 16-byte chunks: ldmatrix's 8 rows
                # fall on distinct banks
                assert p.q_ld == p.k_ld == p.v_ld == 2 * p.dp + 16
                assert (p.q_ld // 16) % 2 == 1
            else:
                assert p.q_ld == p.k_ld == (p.dp + 8) * 4
                assert p.v_ld == (p.dp + 4) * 4
            assert p.stage == p.bk * (p.k_ld + p.v_ld)
            # the warps sharing a row group exchange partial scores
            part = p.rows // 16 * p.nw * p.bk * 16 * 4 if p.nw > 1 else 0
            assert p.smem == p.rows * p.q_ld + 2 * p.stage + part
            assert p.smem <= SMEM_LIMIT
            assert p.vec == int((dh * elem_size) % 16 == 0)
            assert len(p.launch_ints()) == 11


def test_plan_at_the_served_shapes():
    """RecurrentGemma-2B's 4,096-token prefill: 32 query tiles of 128 rows
    per head (one block an SM: eight warps and 202,752 bytes in bf16,
    sixteen warps, two a row group, and 218,624 bytes in fp32); a 128-row
    tile walks at most 2,048 + 128 keys.  Its 13-token prefill and
    stablelm-3b's take 16-row tiles shared by four warps."""
    bf = flash_plan(1, 10, 4096, 4096, 256, 2, True, 2048)
    f32 = flash_plan(1, 10, 4096, 4096, 256, 4, True, 2048)
    assert (bf.rows, bf.bk, bf.dmax, bf.smem) == (128, 64, 256, 202752)
    assert (f32.rows, f32.bk, f32.nw, f32.smem) == (128, 16, 2, 218624)
    assert bf.grid == (10, 32, 1)
    assert max(ke - kb for kb, ke in map(bf.walk, range(32))) <= 2048 + 128
    short = flash_plan(1, 10, 13, 13, 256, 2, True, 2048)
    assert (short.rows, short.bk, short.nw, short.grid, short.walk(0)) == (
        16, 16, 4, (10, 1, 1), (0, 13))
    lm = flash_plan(1, 32, 13, 13, 80, 2)
    assert (lm.rows, lm.dp, lm.dmax, lm.bk, lm.vec) == (16, 80, 128, 16, 1)
    assert flash_plan(1, 32, 13, 13, 80, 2, aligned=False).vec == 0
    assert flash_plan(1, 32, 2048, 2048, 80, 4).rows == 64
    # What chip_smoke.py times the choice by: either tile, forced.
    assert flash_plan(1, 10, 13, 13, 256, 2, few_rows=False).rows == 128
    assert flash_plan(1, 10, 4096, 4096, 256, 2, few_rows=True).grid == (
        10, 256, 1)


def test_plan_refuses_head_dims_past_the_kernel():
    for dh in (0, 257):
        with pytest.raises(ValueError):
            flash_plan(1, 1, 4, 4, dh, 2)
