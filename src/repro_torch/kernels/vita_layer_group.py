"""Layer groups on Hopper: L fused encoder layers in one launch, float and
int8.

Counterpart of `repro/kernels/vita_layer.py::vita_layer_group` and
`::vita_layer_group_int8`.  The TPU kernel runs a sequential (B, L, H) grid
with the activation resident in VMEM across all L layers.  Here each group
call is ONE cooperative launch of ``csrc/vita_layer_group.cu``: a
persistent grid walks seven stages per layer (LN1, Q/K/V, attention,
concat + residual, LN2, up + GELU, down + residual) with a grid-wide
barrier between stages, reusing the per-layer chain's own tile code.  The
activation is carried between layers in a float32 buffer and rounded to
x's dtype once, at the end, as the TPU kernel carries it in fp32 scratch:
with float32 x a float group equals L calls of `tile_chain` (the float
layer over the same tiles: csrc/layer_norm.cu, csrc/gemm_f32.cu and
csrc/attention.cu, the chain `vita_layer.vita_layer` ran before it moved
onto the tensor cores; kept to hold the group to, run by the tests and
chip_smoke.py, never on a served path) and an int8 group L calls of
`vita_layer.vita_layer_int8`; with bf16 x it is not (each call rounds its
output).  The source note says what bounds it and how its design differs
from the TPU's.

Operands carry the layer as their leading axis: wq/wk/wv (L, H, D, Dh);
w_msa (L, H*Dh, D); w_up (L, D, M); w_down (L, M, D); LN vectors and
b_down (L, D); b_up (L, M).  Windowed (Swin) groups take ``bias``
(L, H, n, n) and one shared ``mask`` (nW, n, n): members share window and
shift.  The float group takes x and the stacks in a mode of
`ref.PORTED_MODES`; the int8 group float32 x with float32 or bf16 LN
vectors and biases.  The wrapper allocates the workspace (z, q, k, v, sa,
h1, hid, the float32 carry and the barrier counter) as one buffer.  These
functions take CUDA tensors only; the plain versions are
`ref.vita_layer_group_ref` / `vita_layer_group_int8_ref`, chosen by
`ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .int8_matmul import (DTYPE_CODES, _stream, b_layout, check, dtype_code,
                          ptr)
from .ref import check_mode
from .vita_layer import _attend, launch_layer_norm
from .vita_msa import SMEM_LIMIT, msa_plan

_ALIGN = 256
LN_EPS = 1e-5


def group_smem_bytes(n: int, dh: int) -> int:
    """Dynamic shared memory of one group-kernel block: the attention
    stage's K [N][Dh+1], V [N][Dh] and 8 query and score rows (the GEMM
    tiles need less)."""
    return 4 * (n * (2 * dh + 1) + 8 * (dh + n))


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
    if (bias is None) != (mask is None):
        raise ValueError("windowed mode needs both bias and mask (pass a "
                         "zero mask for unshifted blocks)")
    n_w = 1
    if bias is not None:
        check(bias, "bias", torch.float32, (n_l, h, n, n))
        check(mask, "mask", torch.float32)
        n_w = mask.shape[0]
        if tuple(mask.shape) != (n_w, n, n) or n_w == 0 or b % n_w:
            raise ValueError(f"mask has shape {tuple(mask.shape)}; expected "
                             f"(nW, {n}, {n}) with nW dividing the batch {b}")
    if group_smem_bytes(n, dh) > SMEM_LIMIT:
        raise ValueError(f"layer group: N={n}, Dh={dh} needs more shared "
                         f"memory than one block has")
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
    msa_plan(n, dh, 4, wq.element_size())
    out = torch.empty_like(x)
    ws = _workspace(x.device, b * n, d, h * dh, m, int8=False)
    build.call("vita_layer_group", "rt_vita_layer_group", ptr(x), ptr(wq),
               ptr(wk), ptr(wv), ptr(w_msa), ptr(ln1_w), ptr(ln1_b),
               ptr(ln2_w), ptr(ln2_b), ptr(w_up), ptr(b_up), ptr(w_down),
               ptr(b_down), ptr(bias), ptr(mask), ptr(out),
               *(ptr(t) for t in ws[1:]), ptr(ws[0]), b, n, d, h, dh, m, n_l,
               n_w, dh ** -0.5, LN_EPS, DTYPE_CODES[x.dtype],
               DTYPE_CODES[wt], _stream())
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
    out = torch.empty_like(x)
    ws = _workspace(x.device, b * n, d, h * dh, m, int8=True)
    build.call("vita_layer_group", "rt_vita_layer_group_int8", ptr(x),
               ptr(wq_q), ptr(wk_q), ptr(wv_q), ptr(wmsa_q), ptr(wup_q),
               ptr(wdown_q), ptr(act_scales), *(ptr(s) for s in scales),
               ptr(ln1_w), ptr(ln1_b), ptr(ln2_w), ptr(ln2_b), ptr(b_up),
               ptr(b_down), ptr(bias), ptr(mask), ptr(out),
               *(ptr(t) for t in ws[1:]), ptr(ws[0]), b, n, d, h, dh, m, n_l,
               n_w, dh ** -0.5, LN_EPS, DTYPE_CODES[vt], _stream())
    return out


def launch_gemm_f32(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    res: Optional[torch.Tensor] = None,
                    gelu: bool = False) -> torch.Tensor:
    """out (M, N) = [res +] act(a (M, K) . w [+ bias]) with fp32 FMAs on
    the current stream (csrc/gemm_f32.cu, the group kernel's GEMM tile);
    ``w`` is (K, N) or a per-head (H, K, Dh) stack.  ``a`` is float32;
    ``w`` and ``bias`` float32 or bf16 (one dtype), ``res`` and ``out``
    float32 or bf16 each."""
    k, n, ldb, grp, grp_stride = b_layout(w)
    m = a.shape[0]
    check(a, "a", torch.float32, (m, k))
    wt = dtype_code("w", w)
    check(w, "w", w.dtype)
    ot = dtype_code("out", out)
    check(out, "out", out.dtype, (m, n))
    if bias is not None:
        check(bias, "bias", w.dtype, (n,))
    rt = 0
    if res is not None:
        rt = dtype_code("res", res)
        check(res, "res", res.dtype, (m, n))
    build.call("gemm_f32", "rt_gemm_f32", ptr(a), k, ptr(w), ldb, grp,
               grp_stride, ptr(out), n, m, n, k, ptr(bias), ptr(res), n,
               int(gelu), wt, rt, ot, _stream())
    return out


def tile_chain(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
               w_down, b_down, bias=None, mask=None) -> torch.Tensor:
    """One float encoder layer as the group kernel's own tiles compute it,
    one launch each: LN1, Q, K, V (gemm_f32), attention, concat +
    residual, LN2, up + GELU, down + residual (9 launches); x (B, N, D)
    -> (B, N, D) in x's dtype, arguments as `vita_layer.vita_layer`.  A
    float group equals L calls of it within fp32 reassociation of the
    same sums (the group carries the activation in fp32).  Not counted in
    `ops.LAUNCHES`: no served path calls it."""
    b, n, d = x.shape
    h, _, dh = wq.shape
    m = w_up.shape[1]
    check_mode("tile_chain", x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w,
               ln2_b, w_up, b_up, w_down, b_down)
    rows = b * n
    x2 = x.reshape(rows, d)

    def empty(cols):
        return torch.empty((rows, cols), device=x.device, dtype=torch.float32)

    z = launch_layer_norm(x2, ln1_w, ln1_b, empty(d))
    qkv = [launch_gemm_f32(z, w, empty(h * dh)) for w in (wq, wk, wv)]
    sa = _attend(*qkv, empty(h * dh), b, n, h, dh, bias, mask)
    h1 = launch_gemm_f32(sa, w_msa, empty(d), res=x2)
    z2 = launch_layer_norm(h1, ln2_w, ln2_b, empty(d))
    hid = launch_gemm_f32(z2, w_up, empty(m), bias=b_up, gelu=True)
    y = launch_gemm_f32(hid, w_down, torch.empty_like(x2), bias=b_down,
                        res=h1)
    return y.reshape(b, n, d)
