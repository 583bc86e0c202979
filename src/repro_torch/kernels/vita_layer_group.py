"""Layer groups on Hopper: L fused encoder layers in one launch, float and
int8.

Counterpart of `repro/kernels/vita_layer.py::vita_layer_group` and
`::vita_layer_group_int8`.  The TPU kernel runs a sequential (B, L, H) grid
with the activation resident in VMEM across all L layers.  Here each group
call is ONE cooperative launch of ``csrc/vita_layer_group.cu``: a
persistent grid walks seven stages per layer (LN1, Q/K/V, attention,
concat + residual, LN2, up + GELU, down + residual) with a grid-wide
barrier between stages.  The float kernel runs the float layer's own
tensor-core tiles (`vita_layer.vita_layer`: the MSA tile's projection and
attention, the split-TF32 GEMM tile), 512 threads a block, as `group_plan`
lays them out; the int8 kernel runs the int8 chain's tiles (kernel 4's
int8 tensor-core GEMM tile and the split-TF32 attention tile of
`vita_msa.attention_plan`), 256 threads a block, as `int8_group_plan` lays
them out.  The activation is carried between layers in a float32 buffer
and rounded to x's dtype once, at the end, as the TPU kernel carries it in
fp32 scratch:
with float32 x a float group equals L calls of `vita_layer.vita_layer` and
an int8 group L calls of `vita_layer.vita_layer_int8`, bit for bit; with
bf16 x it is not (each call rounds its output).  The source note says what
bounds it and how its design differs from the TPU's.

Operands carry the layer as their leading axis: wq/wk/wv (L, H, D, Dh);
w_msa (L, H*Dh, D); w_up (L, D, M); w_down (L, M, D); LN vectors and
b_down (L, D); b_up (L, M).  Windowed (Swin) groups take ``bias``
(L, H, n, n) and one shared ``mask`` (nW, n, n): members share window and
shift.  The float group takes x and the stacks in a mode of
`ref.PORTED_MODES` and the (N, Dh) the MSA tile's plan fits (as the float
layer); the int8 group float32 x with float32 or bf16 LN vectors and
biases.  The wrapper allocates the workspace (z, q, k, v, sa, h1, hid, the
float32 carry and the barrier counter) as one buffer.  These functions
take CUDA tensors only; the plain versions are `ref.vita_layer_group_ref` /
`vita_layer_group_int8_ref`, chosen by `ops`.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import build
from .build import DTYPE_CODES, check, ptr, sm_count, stream
from .int8_matmul import I8_STAGES, I8_TILE, _width
from .ref import check_mode
from .vita_msa import (ATT_THREADS, AttentionPlan, MsaPlan, attention_plan,
                       msa_plan, window_operands)
from .vita_layer import float_chain, launch_mma_gemm

_ALIGN = 256
LN_EPS = 1e-5
# The float kernel's block and its GEMM tile (csrc/mma_gemm.cuh: MG_BM x
# MG_BN outputs, a 4-stage ring of A [32][BK + 8] fp32 and B [BK][64 + 4
# (fp32) or + 8 (bf16)], BK = 32 with fp32 and 64 with bf16 weights).
GROUP_THREADS, _MG_BM, _MG_BN, _MG_STAGES = 512, 32, 64, 4
_ROWS_A_WARP = GROUP_THREADS // 32     # LN: one row a warp


class GroupStage(NamedTuple):
    """One stage of the float group kernel: ``count`` tiles of ``rows`` x
    ``cols`` outputs each, covering ``out_rows`` x ``out_cols``, walked by
    the grid in ``waves`` rounds."""
    name: str
    rows: int
    cols: int
    out_rows: int
    out_cols: int
    count: int
    waves: int


class GroupPlan(NamedTuple):
    """One float csrc/vita_layer_group.cu launch: ``grid`` blocks of
    ``threads`` with ``smem`` bytes of dynamic shared memory each (the MSA
    tile's layout ``msa`` on the fp32 LN1 output, and where it is paged
    the attention tile's layout ``att``, which the GEMM tile's ring fits
    inside), and each stage's tiles."""
    msa: MsaPlan
    att: AttentionPlan
    grid: int
    threads: int
    smem: int
    stages: tuple

    def launch_ints(self):
        """The 29 ints the C entry takes (csrc/vita_layer_group.cu's
        GroupLayout): the MSA layout, the attention layout, the grid and
        the shared memory."""
        return tuple(self.msa) + tuple(self.att) + (self.grid, self.smem)

    @property
    def kernel_dp(self) -> int:
        """The DP of the kernel that runs the plan: the MSA layout's for a
        cluster plan, 0 (the paged plans' own kernel) for a paged one."""
        return 0 if self.msa.paged else self.msa.dp


def _mg_smem(w_size: int) -> int:
    """Shared memory of the GEMM tile's ring (csrc/mma_gemm.cuh MgSmem)."""
    bk = 32 if w_size == 4 else 64
    ldb = _MG_BN + (4 if w_size == 4 else 8)
    return _MG_STAGES * (_MG_BM * (bk + 8) * 4 + bk * ldb * w_size)


@functools.lru_cache(maxsize=None)
def group_plan(b: int, n: int, d: int, h: int, dh: int, m: int,
               w_size: int = 4, sms: int = 132,
               per_sm: int = 1) -> GroupPlan:
    """The float group kernel's plan for B images of N tokens, width D,
    H heads of Dh and an MLP of M, weights of ``w_size`` bytes, on ``sms``
    SMs holding ``per_sm`` blocks each: the grid (as many blocks as fit at
    once, and no more than the widest stage has tiles), the shared memory,
    and per stage the tiles: LN1 and LN2 a row a warp; the projection one
    (image, head, 64-row slice) each, the MSA tile's; the attention the
    same, or under a paged MSA plan one (image, head, 32-query slice)
    each, the attention tile's; concat, up and down the GEMM tile's 32 x
    64 outputs.  Raises ValueError for the shapes `vita_msa.msa_plan`
    refuses (the float layer refuses the same)."""
    msa = msa_plan(n, dh, 4, w_size)
    att = attention_plan(n, dh)
    rows, slices = b * n, b * h * msa.cluster
    att_rows = att.rows if msa.paged else msa.rows

    def gemm(cols):
        return -(-rows // _MG_BM) * -(-cols // _MG_BN)

    # (name, tile rows, tile columns, output rows, output columns, tiles);
    # the MSA stages' outputs are per (image, head).
    stages = (("ln1", 1, d, rows, d, rows),
              ("qkv", msa.rows, 3 * dh, n, 3 * dh, slices),
              ("attention", att_rows, dh, n, dh,
               b * h * -(-n // att_rows)),
              ("concat", _MG_BM, _MG_BN, rows, d, gemm(d)),
              ("ln2", 1, d, rows, d, rows),
              ("up", _MG_BM, _MG_BN, rows, m, gemm(m)),
              ("down", _MG_BM, _MG_BN, rows, d, gemm(d)))
    # A block takes one tile a round, or, in LN, a row a warp.
    per_round = [_ROWS_A_WARP if st[1] == 1 else 1 for st in stages]
    work = max(-(-st[5] // r) for st, r in zip(stages, per_round))
    grid = max(1, min(per_sm * sms, work))
    return GroupPlan(msa, att, grid, GROUP_THREADS,
                     max(msa.smem, _mg_smem(w_size)),
                     tuple(GroupStage(*st, -(-st[5] // (grid * r)))
                           for st, r in zip(stages, per_round)))


def plan_for(x: torch.Tensor, wq: torch.Tensor, m: int) -> GroupPlan:
    """`group_plan` of x (B, N, D) against the (L, H, D, Dh) stack on
    their card, sized by the card's occupancy."""
    b, n, d = x.shape
    _, h, _, dh = wq.shape
    w_size = wq.element_size()
    first = group_plan(b, n, d, h, dh, m, w_size, 1, 1)
    per_sm = build.blocks_per_sm("vita_layer_group", "vita_layer_group",
                                 DTYPE_CODES[x.dtype], DTYPE_CODES[wq.dtype],
                                 first.kernel_dp, first.smem)
    return group_plan(b, n, d, h, dh, m, w_size,
                      sm_count(x.device.index or 0), per_sm)


# The int8 kernel's block and its GEMM tile (csrc/mma_gemm_i8.cuh, 64 x 64
# outputs): one KG = 2 tile a block on a 4-stage ring, or two KG = 1 tiles
# a block, one on each half, on 2-stage rings; 64 x (128 + 16) bytes of A
# and 128 x 64 of B a stage, so either takes the same ring bytes.  The
# block is the attention tile's.
INT8_GROUP_THREADS = ATT_THREADS
_I8_STAGE_BYTES = I8_TILE[0] * 144 + 128 * I8_TILE[1]
INT8_GROUP_RING = I8_STAGES * _I8_STAGE_BYTES
_I8_ROWS_A_WARP = INT8_GROUP_THREADS // 32


class Int8GroupStage(NamedTuple):
    """One stage of the int8 group kernel: ``count`` tiles of ``rows`` x
    ``cols`` outputs covering ``out_rows`` x ``out_cols`` (per (image,
    head) in attention), ``per_block`` of them a block a round, walked in
    ``waves`` rounds.  GEMM stages: ``kgroups`` 2 runs one tile a block on
    all its warps, 1 two tiles a block, one a half; A and B copied in
    ``a_chunk`` / ``b_chunk`` bytes (0 outside the GEMMs)."""
    name: str
    rows: int
    cols: int
    out_rows: int
    out_cols: int
    count: int
    per_block: int
    waves: int
    kgroups: int = 0
    a_chunk: int = 0
    b_chunk: int = 0


class Int8GroupPlan(NamedTuple):
    """One int8 csrc/vita_layer_group.cu launch: ``grid`` blocks of
    ``threads`` with ``smem`` bytes of dynamic shared memory each (the
    larger of the GEMM rings and the attention tile's layout ``att``), and
    each stage's tiles."""
    grid: int
    threads: int
    smem: int
    stages: tuple
    att: AttentionPlan

    def launch_ints(self):
        """The 26 ints the C entry takes (csrc/vita_layer_group.cu's
        I8GroupLayout): the grid, the shared memory, per GEMM stage its k
        groups and copy widths, and the attention tile's layout."""
        out = [self.grid, self.smem]
        for st in self.stages:
            if st.kgroups:
                out += [st.kgroups, st.a_chunk, st.b_chunk]
        return tuple(out) + tuple(self.att)


@functools.lru_cache(maxsize=None)
def int8_group_plan(b: int, n: int, d: int, h: int, dh: int, m: int,
                    sms: int = 132, per_sm: int = 1,
                    w_align: tuple = (0, 0, 0, 0)) -> Int8GroupPlan:
    """The int8 group kernel's plan for B images of N tokens, width D, H
    heads of Dh and an MLP of M, on ``sms`` SMs holding ``per_sm`` blocks
    each; ``w_align`` is the weight stacks' addresses modulo 16 for the
    Q/K/V, w_msa, w_up and w_down stages.  The attention stage runs
    `vita_msa.attention_plan`'s tile per (image, head, 32-query slice),
    so this plan raises ValueError where that one does.  A GEMM stage
    whose 64 x 64 tiles fit the card's blocks in one round runs one KG =
    2 tile a block; one with more tiles runs two KG = 1 tiles a block (k
    groups gain only where the tiles leave SMs idle, as in
    `int8_matmul.gemm_i8_plan`).  The
    grid is as many blocks as fit at once, and no more than the widest
    stage has work.  Copy widths as `gemm_i8_plan`'s, each layer's weights
    at their offset in the (L, ...) stack."""
    rows, hd = b * n, h * dh
    cap = per_sm * sms
    bm, bn = I8_TILE
    att = attention_plan(n, dh)

    def gemm(name, k, cols, ldb, grp, grp_stride, layer, align, products=1):
        tiles = products * -(-rows // bm) * -(-cols // bn)
        kg = 2 if tiles <= cap else 1
        return [name, bm, bn, rows, cols, tiles, 3 - kg, kg, _width(k),
                _width(ldb, grp, grp_stride, cols, layer, align)]

    stages = [
        ["ln1", 1, d, rows, d, rows, _I8_ROWS_A_WARP, 0],
        gemm("qkv", d, hd, dh, dh, d * dh, h * d * dh, w_align[0], 3),
        ["attention", att.rows, dh, n, dh, b * h * -(-n // att.rows), 1, 0],
        gemm("concat", hd, d, d, d, 0, hd * d, w_align[1]),
        ["ln2", 1, d, rows, d, rows, _I8_ROWS_A_WARP, 0],
        gemm("up", d, m, m, m, 0, d * m, w_align[2]),
        gemm("down", m, d, d, d, 0, m * d, w_align[3])]
    work = max(-(-st[5] // st[6]) for st in stages)
    grid = max(1, min(cap, work))
    out = []
    for st in stages:
        rounds = -(-st[5] // st[6])
        out.append(Int8GroupStage(*st[:7], -(-rounds // grid), *st[7:]))
    return Int8GroupPlan(grid, INT8_GROUP_THREADS,
                         max(INT8_GROUP_RING, att.smem), tuple(out), att)


def int8_plan_for(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                  wv: torch.Tensor, w_msa: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, vt: int) -> Int8GroupPlan:
    """`int8_group_plan` of x (B, N, D) against the int8 stacks on their
    card, sized by the card's occupancy at LN vectors of type ``vt``."""
    b, n, d = x.shape
    _, h, _, dh = wq.shape
    m = w_up.shape[2]
    align = (math.gcd(*(t.data_ptr() % 16 for t in (wq, wk, wv))),) + tuple(
        t.data_ptr() % 16 for t in (w_msa, w_up, w_down))
    first = int8_group_plan(b, n, d, h, dh, m, 1, 1, align)
    per_sm = build.blocks_per_sm("vita_layer_group", "vita_layer_group_int8",
                                 vt, first.smem)
    return int8_group_plan(b, n, d, h, dh, m, sm_count(x.device.index or 0),
                           per_sm, align)


def _workspace(device, rows: int, d: int, hd: int, m: int, int8: bool):
    """One buffer carved into the barrier counter and z, q, k, v, sa, h1,
    hid and the carry (z, sa and hid int8 in the int8 kernel)."""
    act, asz = (torch.int8, 1) if int8 else (torch.float32, 4)
    parts = [((1,), torch.int32, 4), ((rows, d), act, asz),
             ((rows, hd), torch.float32, 4), ((rows, hd), torch.float32, 4),
             ((rows, hd), torch.float32, 4), ((rows, hd), act, asz),
             ((rows, d), torch.float32, 4), ((rows, m), act, asz),
             ((rows, d), torch.float32, 4)]
    nbytes = [size * shape[0] * (shape[1] if len(shape) > 1 else 1)
              for shape, _, size in parts]
    padded = [-(-nb // _ALIGN) * _ALIGN for nb in nbytes]
    buf = torch.empty(sum(padded), device=device, dtype=torch.uint8)
    views, off = [], 0
    for (shape, dtype, _), nb, pad in zip(parts, nbytes, padded):
        views.append(buf[off:off + nb].view(dtype).view(shape))
        off += pad
    return views


def _check_common(x, wq, w_msa, w_up, w_down, vecs_d, b_up, bias, mask,
                  wdtype, vdtype):
    """Shapes (b, n, d, L, h, dh, m, nW) of a group call, after checking
    every operand (weights of ``wdtype``, LN vectors and biases of
    ``vdtype``); raises on what the kernel does not take."""
    check(x, "x", x.dtype)
    b, n, d = x.shape
    n_l, h, _, dh = wq.shape
    m = w_up.shape[2]
    check(w_msa, "w_msa", wdtype, (n_l, h * dh, d))
    check(w_up, "w_up", wdtype, (n_l, d, m))
    check(w_down, "w_down", wdtype, (n_l, m, d))
    for t, nm in vecs_d:
        check(t, nm, vdtype, (n_l, d))
    check(b_up, "b_up", vdtype, (n_l, m))
    _, _, n_w = window_operands(bias, mask, b=b, n=n, heads=(n_l, h))
    return b, n, d, n_l, h, dh, m, n_w


def vita_layer_group(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                     w_up, b_up, w_down, b_down,
                     bias: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L float encoder layers on the card in one launch: x (B, N, D) ->
    (B, N, D) in x's dtype, the stacks in one dtype that with x's is a
    mode of `ref.PORTED_MODES`."""
    wt = check_mode("vita_layer_group", x, wq, wk, wv, w_msa, ln1_w, ln1_b,
                    ln2_w, ln2_b, w_up, b_up, w_down, b_down)
    b, n, d, n_l, h, dh, m, n_w = _check_common(
        x, wq, w_msa, w_up, w_down,
        ((ln1_w, "ln1_w"), (ln1_b, "ln1_b"), (ln2_w, "ln2_w"),
         (ln2_b, "ln2_b"), (b_down, "b_down")), b_up, bias, mask, wt, wt)
    for w, nm in ((wq, "wq"), (wk, "wk"), (wv, "wv")):
        check(w, nm, wt, (n_l, h, d, dh))
    # The shapes the float layer's MSA tile takes (fp32 LN1 output), so a
    # grouped and a per-layer schedule serve the same models.
    plan = plan_for(x, wq, m).launch_ints()
    out = torch.empty_like(x)
    ws = _workspace(x.device, b * n, d, h * dh, m, int8=False)
    build.call("vita_layer_group", "rt_vita_layer_group", ptr(x), ptr(wq),
               ptr(wk), ptr(wv), ptr(w_msa), ptr(ln1_w), ptr(ln1_b),
               ptr(ln2_w), ptr(ln2_b), ptr(w_up), ptr(b_up), ptr(w_down),
               ptr(b_down), ptr(bias), ptr(mask), ptr(out),
               *(ptr(t) for t in ws[1:]), ptr(ws[0]), b, n, d, h, dh, m, n_l,
               n_w, dh ** -0.5, LN_EPS, DTYPE_CODES[x.dtype],
               DTYPE_CODES[wt], build.ints(plan), stream())
    return out


def vita_layer_group_int8(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                          act_scales, wq_scale, wk_scale, wv_scale,
                          wmsa_scale, wup_scale, wdown_scale, ln1_w, ln1_b,
                          ln2_w, ln2_b, b_up, b_down,
                          bias: Optional[torch.Tensor] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """L int8 encoder layers on the card in one launch: x (B, N, D)
    float32 -> float32.  ``act_scales`` (L, 4) holds each member's frozen
    [qkv_in, w_msa, w_up, w_down] scales; weight scales are (L, H, Dh) for
    Q/K/V and per output channel (L, D) / (L, M) / (L, D); LN vectors and
    biases float32 or bf16."""
    check(x, "x", torch.float32)
    vt = check_mode("vita_layer_group_int8", x, ln1_w, ln1_b, ln2_w, ln2_b,
                    b_up, b_down)
    b, n, d, n_l, h, dh, m, n_w = _check_common(
        x, wq_q, wmsa_q, wup_q, wdown_q,
        ((ln1_w, "ln1_w"), (ln1_b, "ln1_b"), (ln2_w, "ln2_w"),
         (ln2_b, "ln2_b"), (b_down, "b_down")), b_up, bias, mask,
        torch.int8, vt)
    check(act_scales, "act_scales", torch.float32, (n_l, 4))
    for w, nm in ((wq_q, "wq_q"), (wk_q, "wk_q"), (wv_q, "wv_q")):
        check(w, nm, torch.int8, (n_l, h, d, dh))
    scales = []
    for s, nm, numel in ((wq_scale, "wq_scale", h * dh),
                         (wk_scale, "wk_scale", h * dh),
                         (wv_scale, "wv_scale", h * dh),
                         (wmsa_scale, "wmsa_scale", d),
                         (wup_scale, "wup_scale", m),
                         (wdown_scale, "wdown_scale", d)):
        check(s, nm, torch.float32)
        if s.numel() != n_l * numel:
            raise ValueError(f"{nm} has {s.numel()} values, expected "
                             f"{n_l} x {numel}")
        scales.append(s)
    plan = int8_plan_for(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q,
                         DTYPE_CODES[vt]).launch_ints()
    out = torch.empty_like(x)
    ws = _workspace(x.device, b * n, d, h * dh, m, int8=True)
    build.call("vita_layer_group", "rt_vita_layer_group_int8", ptr(x),
               ptr(wq_q), ptr(wk_q), ptr(wv_q), ptr(wmsa_q), ptr(wup_q),
               ptr(wdown_q), ptr(act_scales), *(ptr(s) for s in scales),
               ptr(ln1_w), ptr(ln1_b), ptr(ln2_w), ptr(ln2_b), ptr(b_up),
               ptr(b_down), ptr(bias), ptr(mask), ptr(out),
               *(ptr(t) for t in ws[1:]), ptr(ws[0]), b, n, d, h, dh, m, n_l,
               n_w, dh ** -0.5, LN_EPS, DTYPE_CODES[vt],
               build.ints(plan), stream())
    return out


def tile_chain(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
               w_down, b_down, bias=None, mask=None) -> torch.Tensor:
    """`vita_layer.vita_layer` on the tiles the float group runs: its three
    products on `launch_mma_gemm`'s tile whatever the weights' dtype, so
    with float32 x L calls equal one group bit for bit.  For the checks
    that hold the group to it (tests, chip_smoke.py); not counted in
    ``ops.LAUNCHES``."""
    return float_chain(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                       w_up, b_up, w_down, b_down, bias, mask,
                       gemm=launch_mma_gemm)
