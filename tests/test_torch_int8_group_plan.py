"""The int8 layer group's launch plan
(`kernels/vita_layer_group.py::int8_group_plan`) on the CPU.

For every (N, Dh, D, M) and surviving head count the registry serves, at
full and reduced size, batch 1 and 8: the grid fits the card's resident
blocks and is no larger than the widest stage's work; each stage's tiles
cover its output once; a GEMM stage runs one KG = 2 tile a block where
its tiles fit the grid in one round and two KG = 1 tiles a block
otherwise; the shared memory is the larger of the GEMM rings and the
attention tile's layout (`vita_msa.attention_plan`, passed to the kernel
after the GEMM stages' ints) and fits one H100 block.  At DeiT-T, Swin-T
stage 4 and the pruned L 2 H 2 shape the tile counts are the GEMM and
attention work the kernel walks."""

import pytest

from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.int8_matmul import gemm_i8_plan
from repro_torch.kernels.vita_layer_group import (INT8_GROUP_RING,
                                                  Int8GroupPlan,
                                                  int8_group_plan)
from repro_torch.kernels.vita_msa import attention_plan

from test_torch_group_plan import _served_group_shapes

_GEMMS = ("qkv", "concat", "up", "down")


def _check(p, b, n, d, h, dh, m, sms, per_sm):
    rows, hd = b * n, h * dh
    assert isinstance(p, Int8GroupPlan) and p.threads == 256
    assert 1 <= p.grid <= sms * per_sm
    assert p.att == attention_plan(n, dh)
    assert p.smem == max(INT8_GROUP_RING, p.att.smem)
    assert INT8_GROUP_RING == 4 * (64 * 144 + 128 * 64)
    want = {"ln1": (rows, d), "qkv": (rows, hd), "attention": (n, dh),
            "concat": (rows, d), "ln2": (rows, d), "up": (rows, m),
            "down": (rows, d)}
    assert [s.name for s in p.stages] == list(want)
    work = 0
    for s in p.stages:
        assert (s.out_rows, s.out_cols) == want[s.name]
        tiles_r, tiles_c = -(-s.out_rows // s.rows), -(-s.out_cols // s.cols)
        # Tiles cover the output exactly once: the last row and column of
        # tiles reach past the edge by less than one tile.
        assert tiles_r * s.rows >= s.out_rows > (tiles_r - 1) * s.rows
        assert tiles_c * s.cols >= s.out_cols > (tiles_c - 1) * s.cols
        per = {"qkv": 3, "attention": b * h}.get(s.name, 1)
        assert s.count == tiles_r * tiles_c * per
        rounds = -(-s.count // s.per_block)
        work = max(work, rounds)
        assert s.waves == -(-rounds // p.grid)
        if s.name in _GEMMS:
            assert (s.rows, s.cols) == (64, 64)
            assert s.kgroups == (2 if s.count <= sms * per_sm else 1)
            assert s.per_block == 3 - s.kgroups
        else:
            assert s.kgroups == s.a_chunk == s.b_chunk == 0
            assert s.per_block == (8 if s.rows == 1 else 1)
    assert p.grid == min(sms * per_sm, work)
    ints = p.launch_ints()
    assert ints[:2] == (p.grid, p.smem) and len(ints) == 26
    assert ints[2:14] == tuple(v for s in p.stages if s.name in _GEMMS
                               for v in (s.kgroups, s.a_chunk, s.b_chunk))
    assert ints[14:] == tuple(p.att)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("model,b,n,d,h,dh,m", _served_group_shapes())
def test_every_served_int8_group_has_a_plan_that_tiles_it(model, b, n, d, h,
                                                         dh, m, per_sm):
    p = int8_group_plan(b, n, d, h, dh, m, 132, per_sm)
    _check(p, b, n, d, h, dh, m, 132, per_sm)
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("case,shape,work", [
    # (B, N, D, H, Dh, M); tiles of qkv, attention, concat, up, down
    ("deit_t", (8, 196, 192, 3, 64, 768), (225, 168, 75, 300, 75)),
    ("swin_t stage 4", (8, 49, 768, 24, 32, 3072), (252, 384, 84, 336, 84)),
    ("deit_t pruned L2 H2", (8, 196, 192, 2, 64, 768),
     (150, 112, 75, 300, 75))])
def test_int8_group_work_at_the_timed_shapes(case, shape, work):
    """The tiles each stage walks at chip_smoke.py's three int8 group
    cases, on an H100 holding two blocks an SM: Q/K/V 3 x 25 x 3 tiles at
    DeiT-T, attention per (image, head, 32-query tile), and the up product
    (300 tiles, more than the 264 blocks) as two KG = 1 tiles a block."""
    b, n, d, h, dh, m = shape
    p = int8_group_plan(*shape, 132, 2)
    stages = {s.name: s for s in p.stages}
    assert tuple(stages[k].count for k in ("qkv", "attention", "concat",
                                           "up", "down")) == work
    rows = b * n
    for name, k, cols in (("concat", h * dh, d), ("up", d, m),
                          ("down", m, d)):
        assert stages[name].count == gemm_i8_plan(
            rows, cols, k, ldb=cols, grp=cols, grp_stride=0).tiles
    assert stages["up"].kgroups == 1 and stages["up"].waves == 1
    assert all(stages[g].a_chunk == stages[g].b_chunk == 16 for g in _GEMMS)
    _check(p, b, n, d, h, dh, m, 132, 2)
    if case == "deit_t":
        assert p.smem == 107776 and 2 * p.smem <= 228 * 1024
        assert p.grid == 225 and stages["qkv"].kgroups == 2
    if case == "swin_t stage 4":
        assert p.smem == INT8_GROUP_RING and p.grid == 264


def test_int8_group_copy_widths_follow_the_heads_and_alignment():
    """Dh 24 heads: the per-head stack's chunks stay inside a head (8
    bytes); a weight stack 4 bytes off alignment copies in 4-byte chunks;
    a ragged width copies A by bytes."""
    p = int8_group_plan(2, 17, 96, 4, 24, 384)
    st = {s.name: s for s in p.stages}
    assert st["qkv"].b_chunk == 8 and st["up"].b_chunk == 16
    p = int8_group_plan(2, 17, 96, 4, 24, 384, w_align=(0, 4, 0, 0))
    assert {s.name: s for s in p.stages}["concat"].b_chunk == 4
    p = int8_group_plan(2, 17, 90, 3, 30, 250)
    st = {s.name: s for s in p.stages}
    assert (st["up"].a_chunk, st["down"].a_chunk) == (1, 1)
    assert st["qkv"].b_chunk == 1 and st["concat"].a_chunk == 1
