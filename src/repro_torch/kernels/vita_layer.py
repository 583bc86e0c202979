"""The fused ViTA encoder layer on Hopper, float and int8.

Counterpart of `repro/kernels/vita_layer.py::vita_layer` and
`::vita_layer_int8`.  The TPU kernel runs the whole layer on a sequential
(B, H) grid with x, z and the concat accumulator resident in VMEM.  That
does not carry over: Hopper blocks run in parallel and carry nothing
between them, and at DeiT-T widths x, z and the accumulator are 147 KiB
each per image (w_up alone 576 KiB in fp32) against 227 KB of shared
memory a block.  So the layer is a chain of kernels whose intermediates
(SA, h1, the MLP hidden; Q/K/V too in the int8 chain) go through device
memory — at these sizes they stay in the 50 MB L2.  This drops the TPU
kernel's "nothing leaves the grid" property.

  float: LN1 (csrc/layer_norm.cu) -> the MSA tile (csrc/vita_msa.cu, one
         thread-block cluster per (image, head), or at N and Dh up to 32
         one block per floor(64 / N) whole sequences and all heads: Q/K/V
         projected on chip and never stored, SA written merged (B*N,
         H*Dh) in fp32) ->
         concat GEMM + residual -> LN2 -> up GEMM + bias + GELU -> down
         GEMM + bias + residual.                              (6 launches)
         The three GEMMs (`launch_layer_gemm`): with fp32 weights and
         16-byte aligned rows, csrc/gemm_wgmma.cu (wgmma fed by a TMA ring,
         the weights split into hi and lo planes once, `weight_planes`;
         tile and ring from `gemm_wgmma_plan`); with bf16 weights or
         unaligned rows, csrc/mma_gemm.cu's mma.sync tile.
         Bound: operations, 2*B*N*(3*D*H*Dh + H*Dh*D + 2*D*M) for the
         products plus 4*B*H*N*N*Dh for the attention.  Every product runs
         on the tensor cores: split TF32 on fp32 operands (three passes
         with fp32 weights, two with bf16 weights, which TF32 holds
         exactly), so the sums are fp32-accurate in every mode (measured
         on an H100 at DeiT-T batch 8: 1.6e-6 of an output scale of 6.0
         in fp32, 1.7e-6 of 5.7 with bf16 weights).
  int8:  LN1 quantises to int8 at act_scales[0] -> Q, K, V int8 GEMMs
         (csrc/gemm_i8.cu) whose epilogue applies act_scales[0] * w_scale
         -> attention (csrc/attention.cu, split TF32 on the tensor
         cores) writes SA quantised at
         act_scales[1] -> concat GEMM + residual -> LN2 quantising at
         act_scales[2] -> up GEMM + bias + GELU quantising at
         act_scales[3] -> down GEMM + bias + residual.        (9 launches)

Shapes: the float layer takes the (N, Dh) the MSA tile's plan fits
(`vita_msa.msa_plan`: one cluster where K and V of all N tokens fit a
block, else the paged plan: the projection, then the attention tile,
seven launches), and the float layer group refuses the rest too; the
int8 layer takes the (N, Dh) its attention tile's plan fits
(`vita_msa.attention_plan`).  Both: Dh <= 128, N up to 704 at Dh 65-128,
1,216 at Dh 33-64 and 1,472 at Dh 32.

On a model-axis mesh (``msa_axis`` / ``mlp_axis``, process groups) each
rank holds its heads with their concat rows and its MLP columns with
their down rows, and the chain splits at the two row-parallel products:
the concat GEMM and the down GEMM run without their ``res`` / ``bias``
epilogue terms, their partials are all-reduced over the axis, and x,
``b_down`` and h1 are added once, after the sum (an addend left in an
epilogue would be counted once per rank).  In the int8 chain the
epilogue's x_scale * w_scale still applies per rank: those scales span
the full output width, so the scaled partials sum exactly.  Without an
axis the chain is unchanged, launch for launch.

Windowed (Swin) mode: the caller folds windows into the batch axis and
passes ``bias`` (H, n, n) and ``mask`` (nW, n, n); every step of a chain
but attention is per token, so only the attention launch takes them.

dtype modes (`ref.PORTED_MODES`), as the TPU kernel runs them: x is
float32 or bf16, the weights, LN vectors and biases float32 or bf16, and
every intermediate (z, Q/K/V, P and V, SA, h1, the hidden) is float32, so
bf16 weights are used exactly; only the last GEMM rounds, writing y in x's
dtype (the TPU kernel's fp32 scratch and its output cast).  The int8 layer
takes float32 x and float32 or bf16 LN vectors and biases.
These functions take CUDA tensors only; the plain versions are
`ref.vita_layer_ref` / `vita_layer_int8_ref`, chosen by `ops`.
"""

from __future__ import annotations

import functools
import math
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import trace as _trace

from . import build
from .build import (DTYPE_CODES, SMEM_LIMIT, check, dtype_code, ptr,
                    sm_count, stream)
from .int8_matmul import launch_gemm_i8
from .ref import check_mode, psum
from .vita_msa import launch_attention, launch_msa

# Kernel 1's float products (`launch_layer_gemm`): M*N*K of each, the
# part on the wgmma route, and that route's tiles, padding included.
_GEMM_MACS = _trace.counter("kernels.gemm_macs")
_GEMM_WGMMA_MACS = _trace.counter("kernels.gemm_wgmma_macs")
_GEMM_TILE_MACS = _trace.counter("kernels.gemm_tile_macs")


def launch_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      out: torch.Tensor, *, eps: float = 1e-5,
                      q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row LayerNorm of x (R, D) into ``out`` (float32, or int8 quantised
    at ``q_scale``) on the current stream; x and the LN vectors are
    float32 or bf16 (a mode of `ref.PORTED_MODES`)."""
    rows, d = x.shape
    vt = check_mode("layer_norm", x, w, b)
    check(x, "x", x.dtype)
    check(w, "ln weight", vt, (d,))
    check(b, "ln bias", vt, (d,))
    check(out, "out", torch.int8 if q_scale is not None else torch.float32,
          (rows, d))
    if q_scale is not None:
        check(q_scale, "q_scale", torch.float32, (1,))
    build.call("layer_norm", "rt_layer_norm", ptr(x), ptr(w), ptr(b),
               ptr(out), rows, d, eps, ptr(q_scale), DTYPE_CODES[x.dtype],
               DTYPE_CODES[vt], stream())
    return out


def launch_mma_gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    res: Optional[torch.Tensor] = None,
                    gelu: bool = False) -> torch.Tensor:
    """out (M, N) = [res +] act(a (M, K) . w (K, N) [+ bias]) on the
    tensor cores (fp32-accurate split TF32) on the current stream.  ``a``
    is float32; ``w`` and ``bias`` float32 or bf16 (one dtype), ``res``
    and ``out`` float32 or bf16 each."""
    m, k = a.shape
    n = w.shape[1]
    check(a, "a", torch.float32)
    wt = dtype_code("w", w)
    check(w, "w", w.dtype, (k, n))
    ot = dtype_code("out", out)
    check(out, "out", out.dtype, (m, n))
    if bias is not None:
        check(bias, "bias", w.dtype, (n,))
    rt = 0
    if res is not None:
        rt = dtype_code("res", res)
        check(res, "res", res.dtype, (m, n))
    build.call("mma_gemm", "rt_mma_gemm", ptr(a), k, ptr(w), n, ptr(out), n,
               m, n, k, ptr(bias), ptr(res), n, int(gelu), wt, rt, ot,
               stream())
    return out


# The wgmma route (csrc/gemm_wgmma.cuh): a stage is 32 deep (one 128-byte
# swizzled row of floats); tiles of 64 rows a consumer warpgroup (one or
# two) by one of WG_WIDTHS columns; one persistent block an SM.
WG_BK = 32
WG_WIDTHS = (32, 64, 96)
WG_MAX_STAGES = 8
H100_SMS = 132
# Measured on an H100 SXM at 700 W, in us, for (width, consumers): a 32-deep
# stage of one tile while every SM runs one (WG_STAGE_US), and a tile's
# epilogue (WG_EPILOGUE_US: sums, bias, GELU or residual, stores).
# 64 x 64 tiles (0.53 and 2.3 us) lost to another tile at every shape of
# the registry, so no kernel is built for them.
WG_STAGE_US = {(32, 1): 0.37, (96, 1): 0.60,
               (32, 2): 0.51, (64, 2): 0.65, (96, 2): 0.80}
WG_EPILOGUE_US = {(32, 1): 1.2, (96, 1): 3.4,
                  (32, 2): 2.3, (64, 2): 4.0, (96, 2): 7.0}


class WgmmaPlan(NamedTuple):
    """How `launch_wgmma_gemm` runs one product: a tile of ``bm`` = 64 *
    ``consumers`` rows by ``bn`` columns, a ring of ``stages``, ``tiles``
    tiles in ``waves`` rounds of H100_SMS blocks, ``smem`` bytes a
    block."""
    bm: int
    bn: int
    consumers: int
    stages: int
    tiles: int
    waves: int
    smem: int


def wgmma_smem(bm: int, bn: int, stages: int) -> int:
    """Shared memory of a block (csrc/gemm_wgmma.cuh WgSmem::bytes): the
    ring of A [bm][32] and B_hi, B_lo [bn][32] fp32, two mbarriers a stage,
    and 1,024 bytes to align the ring for the swizzle."""
    return stages * ((bm + 2 * bn) * WG_BK * 4 + 16) + 1024


@functools.lru_cache(maxsize=None)
def gemm_wgmma_plan(m: int, n: int, k: int) -> WgmmaPlan:
    """The tile of an (m, k) x (k, n) product: of 64 or 128 rows by each of
    WG_WIDTHS, the one whose rounds of H100_SMS tiles take the least time
    by WG_STAGE_US and WG_EPILOGUE_US; the deepest ring (at most
    WG_MAX_STAGES) that fits SMEM_LIMIT.

    Every fp32 product whose rows are 16-byte aligned takes this route:
    there is no crossover to the mma.sync tile.  At each cell's shapes the
    route measured faster on the card (device us, wgmma at its plan
    against mma.sync): DeiT-S at bucket 32 concat 35 / 82, up 99 / 314,
    down 85 / 276; Swin-T stage 1 up 182 / 536; TNT-S's inner K-24
    products 7.4 / 15.0, 15.5 / 26.1 and 7.9 / 20.3; a one-image Poisson
    bucket's up and down 8.9 / 19.1 and 17.0 / 40.0."""
    steps = -(-k // WG_BK)
    best, best_us = None, math.inf
    for (bn, consumers), stage_us in WG_STAGE_US.items():
        bm = 64 * consumers
        tiles = -(-m // bm) * -(-n // bn)
        waves = -(-tiles // H100_SMS)
        us = waves * (steps * stage_us + WG_EPILOGUE_US[bn, consumers])
        if us < best_us:
            stages = WG_MAX_STAGES
            while wgmma_smem(bm, bn, stages) > SMEM_LIMIT:
                stages -= 1
            best_us = us
            best = WgmmaPlan(bm, bn, consumers, stages, tiles, waves,
                             wgmma_smem(bm, bn, stages))
    return best


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 by csrc/tf32_split.cuh's integer rounding: add
    half a TF32 ulp to the bits, clear the 13 low ones."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_planes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W (K, N) fp32 -> (W_hi^T, W_lo^T), each (N, K) contiguous: the
    K-major hi and lo parts the wgmma route reads as B."""
    with torch.no_grad():
        wt = w.detach().t().contiguous()
        hi = _tf32(wt)
        return hi, _tf32(wt - hi)


# id(w) -> (a weak reference to w, w._version, W_hi^T, W_lo^T): made at a
# weight's first product and again after an in-place update (training
# through ops._KernelGrad bumps ``_version``); the reference's callback
# drops the entry with the weight.  Keyed by id rather than through
# torch.utils.weak's WeakIdKeyDictionary: a lookup here is one dict get on
# every product of the forward (~0.2 us against ~1.2).
_PLANES: dict = {}


def weight_planes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`split_planes` of ``w``, from `_PLANES` unless ``w`` changed."""
    key = id(w)
    got = _PLANES.get(key)
    if got is None or got[0]() is not w or got[1] != w._version:
        got = (weakref.ref(w, lambda _, key=key: _PLANES.pop(key, None)),
               w._version, *split_planes(w))
        _PLANES[key] = got
    return got[2], got[3]


def layer_gemm_plan(a: torch.Tensor, w: torch.Tensor) -> Optional[WgmmaPlan]:
    """The wgmma plan of ``a`` . ``w`` where that route takes it (fp32
    weights, ``a``'s rows 16-byte aligned as TMA needs them), else None:
    `launch_mma_gemm`'s tile (bf16 weights, unaligned rows)."""
    m, k = a.shape
    if w.dtype != torch.float32 or a.data_ptr() % 16 or k % 4:
        return None
    return gemm_wgmma_plan(m, w.shape[1], k)


def launch_wgmma_gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                      *, bias: Optional[torch.Tensor] = None,
                      res: Optional[torch.Tensor] = None, gelu: bool = False,
                      plan: Optional[WgmmaPlan] = None) -> torch.Tensor:
    """`launch_mma_gemm`'s contract on the wgmma route: out (M, N) = [res
    +] act(a (M, K) . w (K, N) [+ bias]), fp32-accurate split TF32, on the
    current stream.  ``a``, ``w`` and ``bias`` float32, ``a``'s rows
    16-byte aligned; ``res`` and ``out`` float32 or bf16 each.  ``plan``
    defaults to `gemm_wgmma_plan`'s tile (a caller may time another)."""
    m, k = a.shape
    if a.data_ptr() % 16 or k % 4:
        raise ValueError("the wgmma route takes 16-byte aligned rows of a")
    return _wgmma(a, w, out, bias, res, gelu,
                  plan or gemm_wgmma_plan(m, w.shape[1], k))


def _wgmma(a, w, out, bias, res, gelu, plan: WgmmaPlan) -> torch.Tensor:
    """`launch_wgmma_gemm` once ``a``'s rows are known aligned."""
    m, k = a.shape
    n = w.shape[1]
    check(a, "a", torch.float32)
    check(w, "w", torch.float32, (k, n))
    ot = dtype_code("out", out)
    check(out, "out", out.dtype, (m, n))
    if bias is not None:
        check(bias, "bias", torch.float32, (n,))
    rt = 0
    if res is not None:
        rt = dtype_code("res", res)
        check(res, "res", res.dtype, (m, n))
    hi, lo = weight_planes(w)
    grid = min(plan.tiles, sm_count(a.get_device()))
    build.call("gemm_wgmma", "rt_gemm_wgmma", ptr(a), k, ptr(hi), ptr(lo),
               ptr(out), n, m, n, k, ptr(bias), ptr(res), n, int(gelu), rt,
               ot, plan.bn, plan.consumers, plan.stages, grid, stream())
    return out


def launch_layer_gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                      *, bias: Optional[torch.Tensor] = None,
                      res: Optional[torch.Tensor] = None,
                      gelu: bool = False) -> torch.Tensor:
    """One of kernel 1's float products (`launch_mma_gemm`'s contract): on
    the wgmma route where `layer_gemm_plan` gives a plan, else on
    `launch_mma_gemm`'s tile."""
    plan = layer_gemm_plan(a, w)
    if _trace.ON:
        m, k = a.shape
        macs = m * w.shape[1] * k
        _trace.count(_GEMM_MACS, macs)
        if plan is not None:
            _trace.count(_GEMM_WGMMA_MACS, macs)
            _trace.count(_GEMM_TILE_MACS, plan.tiles * plan.bm * plan.bn
                         * -(-k // WG_BK) * WG_BK)
    if plan is None:
        return launch_mma_gemm(a, w, out, bias=bias, res=res, gelu=gelu)
    return _wgmma(a, w, out, bias, res, gelu, plan)


def _attend(q, k, v, out, b, n, h, dh, bias, mask, out_scale=None):
    """Merged (B*N, H*Dh) q/k/v -> merged (B*N, H*Dh) attention output."""
    strides = (n * h * dh, h * dh, dh)
    return launch_attention(q, k, v, out, b=b, h=h, n=n, dh=dh,
                            in_strides=strides, out_strides=strides,
                            out_scale=out_scale, bias=bias, mask=mask)


def vita_layer(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up, b_up,
               w_down, b_down, bias=None, mask=None, *, msa_axis=None,
               mlp_axis=None) -> torch.Tensor:
    """One float encoder layer on the card: x (B, N, D) -> (B, N, D) in
    x's dtype.

    wq/wk/wv (H, D, Dh); w_msa (H*Dh, D) with head-major rows; w_up (D,
    M); w_down (M, D); LN vectors and b_down (D,); b_up (M,); all of one
    dtype, which with x's is a mode of `ref.PORTED_MODES`.  Axes: the
    split chain of the module docstring."""
    return float_chain(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b,
                       w_up, b_up, w_down, b_down, bias, mask,
                       msa_axis=msa_axis, mlp_axis=mlp_axis,
                       gemm=launch_layer_gemm)


def float_chain(x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w, ln2_b, w_up,
                b_up, w_down, b_down, bias=None, mask=None, *, gemm,
                msa_axis=None, mlp_axis=None) -> torch.Tensor:
    """`vita_layer` with its three products launched by ``gemm``:
    `launch_layer_gemm` there, `launch_mma_gemm` in
    `vita_layer_group.tile_chain`."""
    b, n, d = x.shape
    h, _, dh = wq.shape
    m = w_up.shape[1]
    wt = check_mode("vita_layer", x, wq, wk, wv, w_msa, ln1_w, ln1_b, ln2_w,
                    ln2_b, w_up, b_up, w_down, b_down)
    check(x, "x", x.dtype)
    check(w_msa, "w_msa", wt, (h * dh, d))
    check(w_up, "w_up", wt, (d, m))
    check(w_down, "w_down", wt, (m, d))
    rows = b * n
    x2 = x.reshape(rows, d)

    def empty(cols):
        return torch.empty((rows, cols), device=x.device, dtype=torch.float32)

    z = launch_layer_norm(x2, ln1_w, ln1_b, empty(d))
    sa = launch_msa(z.view(b, n, d), wq, wk, wv, empty(h * dh),
                    (n * h * dh, h * dh, dh), bias=bias, mask=mask)
    if msa_axis is None:
        h1 = gemm(sa, w_msa, empty(d), res=x2)
    else:
        h1 = psum(gemm(sa, w_msa, empty(d)), msa_axis) + x2
    z2 = launch_layer_norm(h1, ln2_w, ln2_b, empty(d))
    hid = gemm(z2, w_up, empty(m), bias=b_up, gelu=True)
    if mlp_axis is None:
        y = gemm(hid, w_down, torch.empty_like(x2), bias=b_down, res=h1)
    else:
        y = (h1 + psum(gemm(hid, w_down, empty(d)), mlp_axis)
             + b_down.float()).to(x.dtype)
    return y.reshape(b, n, d)


def vita_layer_int8(x, wq_q, wk_q, wv_q, wmsa_q, wup_q, wdown_q, act_scales,
                    wq_scale, wk_scale, wv_scale, wmsa_scale, wup_scale,
                    wdown_scale, ln1_w, ln1_b, ln2_w, ln2_b, b_up, b_down,
                    bias=None, mask=None, *, msa_axis=None,
                    mlp_axis=None) -> torch.Tensor:
    """One int8 encoder layer on the card: x (B, N, D) float32 -> float32
    (axes: the split chain of the module docstring).

    w*_q int8; ``act_scales`` (4,) = frozen [qkv_in, w_msa, w_up, w_down]
    activation scales; w*_scale per-(head, channel) (H, Dh) for QKV and
    per-output-channel (D,)/(M,)/(D,) for the plain matmuls; LN vectors
    and biases float32 or bf16 (read into fp32 in the kernels)."""
    b, n, d = x.shape
    h, _, dh = wq_q.shape
    m = wup_q.shape[1]
    check(x, "x", torch.float32)
    check_mode("vita_layer_int8", x, ln1_w, ln1_b, ln2_w, ln2_b, b_up,
               b_down)
    check(act_scales, "act_scales", torch.float32, (4,))
    check(wmsa_q, "wmsa_q", torch.int8, (h * dh, d))
    check(wup_q, "wup_q", torch.int8, (d, m))
    check(wdown_q, "wdown_q", torch.int8, (m, d))
    s = [act_scales[i:i + 1] for i in range(4)]
    rows = b * n
    x2 = x.reshape(rows, d)

    def empty(cols, dtype=torch.float32):
        return torch.empty((rows, cols), device=x.device, dtype=dtype)

    zq = launch_layer_norm(x2, ln1_w, ln1_b, empty(d, torch.int8),
                           q_scale=s[0])
    qkv = []
    for w, ws in ((wq_q, wq_scale), (wk_q, wk_scale), (wv_q, wv_scale)):
        check(w, "wq/wk/wv", torch.int8, (h, d, dh))
        qkv.append(launch_gemm_i8(zq, w, empty(h * dh), x_scale=s[0],
                                  w_scale=ws.reshape(h * dh)))
    saq = _attend(*qkv, empty(h * dh, torch.int8), b, n, h, dh, bias, mask,
                  out_scale=s[1])
    if msa_axis is None:
        h1 = launch_gemm_i8(saq, wmsa_q, empty(d), x_scale=s[1],
                            w_scale=wmsa_scale.reshape(d), res=x2)
    else:
        h1 = x2 + psum(launch_gemm_i8(saq, wmsa_q, empty(d), x_scale=s[1],
                                      w_scale=wmsa_scale.reshape(d)),
                       msa_axis)
    z2q = launch_layer_norm(h1, ln2_w, ln2_b, empty(d, torch.int8),
                            q_scale=s[2])
    hidq = launch_gemm_i8(z2q, wup_q, empty(m, torch.int8), x_scale=s[2],
                          w_scale=wup_scale.reshape(m), bias=b_up, gelu=True,
                          out_scale=s[3])
    if mlp_axis is None:
        y = launch_gemm_i8(hidq, wdown_q, empty(d), x_scale=s[3],
                           w_scale=wdown_scale.reshape(d), bias=b_down,
                           res=h1)
    else:
        y = h1 + psum(launch_gemm_i8(hidq, wdown_q, empty(d), x_scale=s[3],
                                     w_scale=wdown_scale.reshape(d)),
                      mlp_axis) + b_down.float()
    return y.reshape(b, n, d)
