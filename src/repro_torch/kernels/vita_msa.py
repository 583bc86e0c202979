"""Per-head MSA on Hopper: the unfused executor's float and int8 kernels.

Counterpart of `repro/kernels/vita_msa.py`.

  * `vita_msa_batched` / `vita_msa` replace the float (B, H)-grid Pallas
    kernel: one launch of ``csrc/vita_msa.cu`` runs one thread-block
    cluster per (image, head), whose blocks each project Q, K and V for
    their own rows on the tensor cores, share K and V through distributed
    shared memory and attend with everything kept on chip, so SA is the
    only tensor it writes (`msa_plan` sizes the cluster).  Where K and V
    of all N rows do not fit a block (Dh 65-128, N past 512, or fp32 N
    past 256 at Dh 64) the plan is paged: the same projection writes Q, K
    and V to device memory and the attention tile of ``csrc/attention.cu``
    pages K and V through shared memory (two launches).  z and the
    weights are float32 or bf16 (`ref.PORTED_MODES`); with bf16 z it
    rounds P and V to bf16 before the AV product, as the TPU kernel does,
    and writes SA in z's dtype.  `launch_msa` is the same launch with the
    output strides free: the fused float layer writes SA merged.  Short
    sequences of fp32 z (N and Dh at most 32, `msa_packed_plan`) take the
    packed tile of ``csrc/msa_packed.cuh`` instead: one block per
    floor(64 / N) whole sequences and all their heads, no cluster.
  * `vita_msa_int8` replaces the int8 kernel of the calibration pass and
    the unfused int8 executor: three int8 GEMMs (``csrc/gemm_i8.cu``)
    project Q, K and V with the per-(head, channel) requant (and the
    optional ``qkv_bias``) in their epilogue, reading the (H, D, Dh) weight
    stacks in place, then the attention kernel ``csrc/attention.cu``: a
    block per (image, head, 32-query slice), both products in split TF32
    on the tensor cores, K and V paged through shared memory as
    `attention_plan` lays it out.

All of them take the windowed (Swin) mode: the caller folds windows into
the batch axis and passes ``bias`` (H, N, N) and ``mask`` (nW, N, N).
`launch_attention` is the building block the int8 layer reuses.  These
functions take CUDA tensors only; the plain versions in `ref` are chosen
by `ops` for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch import trace as _trace

from . import build
from .build import (DTYPE_CODES, SMEM_LIMIT, TWO_BLOCK_SMEM, check, ptr,
                    stream)
from .int8_matmul import launch_gemm_i8
from .ref import check_mode

# What `launch_msa` counts while tracing is on (`repro_torch.trace`).
_COUNT_ROWS = _trace.counter("kernels.msa_rows")
_COUNT_TILE_ROWS = _trace.counter("kernels.msa_tile_rows")
_COUNT_PACKED_ROWS = _trace.counter("kernels.msa_packed_rows")

_MSA_ROWS, _MSA_SUB, _MSA_WARPS, _MSA_MAX_CLUSTER = 64, 32, 16, 8
_MSA_MIN_STAGES, _MSA_MAX_STAGES = 3, 8
# The widest head either tile takes (padded to DP 128).
MAX_DH = 128
# The packed tile (csrc/msa_packed.cuh): at most 64 rows a block, N and Dh
# up to 32 (so a block holds two sequences or more), two blocks an SM.
_PACKED_ROWS, _PACKED_MAX_N, _PACKED_MAX_DH = 64, 32, 32
# The int8 chains' attention tile (csrc/attention.cuh): 8 warps, 32 query
# rows, K and V in pages of 64 keys through a ring of 2 or 3 slots.
ATT_THREADS, ATT_ROWS, _ATT_WARPS, _ATT_PAGE = 256, 32, 8, 64
_ATT_STAGES = (3, 2)


class MsaPlan(NamedTuple):
    """One csrc/vita_msa.cu launch, field for field the tile's
    `MsaLayout` (csrc/msa_tile.cuh), which the launch takes as is:
    ``cluster`` blocks per (image, head), each owning ``rows`` tokens;
    ``dp`` is Dh padded to the tile's width, ``nk`` N padded to 16 keys
    and ``lds`` the score rows' stride; the projection's copy ring has
    ``stages`` of ``stage`` bytes; the ``*_off`` are the byte offsets of Q,
    K, V, the scores, bf16 P and the ring in a block's ``smem`` bytes of
    shared memory.  ``paged`` 1: the projection alone, one block per
    (image, head, 64-row slice) at DP 64 or 128, its ring at offset 0 (the
    other offsets, ``nk`` and ``lds`` 0), writing Q, K and V to device
    memory for the attention tile at `attention_plan`; ``smem`` is then
    the larger of the ring and that tile's layout (the layer group's block
    holds both)."""
    dp: int
    rows: int
    cluster: int
    nk: int
    lds: int
    stage: int
    stages: int
    q_off: int
    k_off: int
    v_off: int
    s_off: int
    p_off: int
    ring_off: int
    smem: int
    paged: int = 0


@functools.lru_cache(maxsize=None)
def msa_plan(n: int, dh: int, z_size: int = 4,
             w_size: Optional[int] = None) -> MsaPlan:
    """The MSA tile's layout for N tokens of head width Dh, z and the
    weights of ``z_size`` and ``w_size`` bytes (default: z's).

    A cluster plan where Dh is at most 64, N at most 512 and the layout
    fits one block: one block per 64-row slice of N, at most 8; Q, then K
    and V for all N rows (fp32, V in z's type) and the scores of a 32-row
    pass (with bf16 P in the bf16 mode), each row padded so that fragment
    loads hit distinct banks; and the projection's ring (z [64][KC + 8],
    W [KC][3 DP + pad], KC 32 for fp32 z and 64 for bf16) overlaying K, V
    and the scores, as many stages (3-8) as they hold.

    Otherwise a paged plan (``paged`` 1): the projection at DP 64 (Dh up
    to 64) or 128 (one weight slice a pass, W [KC][DP + pad]) with as many
    ring stages (3-8) as the attention tile's layout holds, and the
    attention tile at `attention_plan` (N, Dh).  Raises ValueError past
    Dh 128 and where `attention_plan` raises (N past 704 at Dh 65-128,
    1,216 at Dh 33-64 and 1,472 at Dh 32): the float layer and layer
    group (kernels 1 and 7) refuse those shapes too, through this plan."""
    w_size = z_size if w_size is None else w_size
    if not 1 <= dh <= MAX_DH or n < 1:
        raise ValueError(f"MSA tile: no plan for N={n}, Dh={dh} "
                         f"(1 <= Dh <= {MAX_DH} and N >= 1 only)")
    rows = _MSA_ROWS
    cluster = -(-n // rows)
    kc = 32 if z_size == 4 else 64
    pad_w = 4 if w_size == 4 else 8
    if dh <= 64 and cluster <= _MSA_MAX_CLUSTER:
        dp = 32 if dh <= 32 else 64
        nk = -(-n // 16) * 16
        lds = -(-nk // 32) * 32 + 8
        ldv = dp + 4 if z_size == 4 else dp + 8
        qb = rows * (dp + 8) * 4
        kb = cluster * rows * (dp + 8) * 4
        vb = cluster * rows * ldv * z_size
        sb = _MSA_SUB * lds * 4
        pb = _MSA_SUB * (nk + 8) * 2 if z_size == 2 else 0
        red = (_MSA_WARPS - 2 * (dp // 16)) * 8 * 32 * 4   # P.V's key groups
        kvs = kb + vb + max(sb + pb, red)
        stage = rows * (kc + 8) * z_size + kc * (3 * dp + pad_w) * w_size
        stages = min(_MSA_MAX_STAGES, max(_MSA_MIN_STAGES, kvs // stage))
        smem = qb + max(kvs, stages * stage)
        if smem <= SMEM_LIMIT:
            return MsaPlan(dp, rows, cluster, nk, lds, stage, stages,
                           q_off=0, k_off=qb, v_off=qb + kb,
                           s_off=qb + kb + vb, p_off=qb + kb + vb + sb,
                           ring_off=qb, smem=smem)
    att = attention_plan(n, dh)
    dp = 64 if dh <= 64 else 128
    parts = 3 if dp == 64 else 1
    stage = rows * (kc + 8) * z_size + kc * (parts * dp + pad_w) * w_size
    stages = min(_MSA_MAX_STAGES, max(_MSA_MIN_STAGES, att.smem // stage))
    return MsaPlan(dp, rows, cluster, 0, 0, stage, stages, q_off=0, k_off=0,
                   v_off=0, s_off=0, p_off=0, ring_off=0,
                   smem=max(stages * stage, att.smem), paged=1)


class PackedPlan(NamedTuple):
    """One packed-tile launch (csrc/msa_packed.cuh), field for field its
    `PackedLayout`, which the launch takes as is: a block owns ``seqs``
    whole sequences, ``rows`` = seqs N tokens; ``kp`` is D padded to the
    MMA's k step of 8 and ``ldz`` z's row stride (floats), ``dp`` Dh
    padded to 8, ``cols`` the projection's 3 H dp columns padded to 16
    and ``ldw`` / ``ldq`` the row strides of the weights (in their type)
    and of Q, K and V (fp32, ``qrows`` rows: what the last sequence's
    16-row query slices read); z lies at 0, the weights at ``w_off``, Q,
    K and V at ``qkv_off`` and SA's staging, over z and the weights, at
    0, in ``smem`` bytes."""
    seqs: int
    rows: int
    kp: int
    ldz: int
    dp: int
    cols: int
    ldw: int
    ldq: int
    qrows: int
    w_off: int
    qkv_off: int
    smem: int


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def msa_packed_plan(n: int, d: int, h: int, dh: int, z_size: int = 4,
                    w_size: Optional[int] = None) -> Optional[PackedPlan]:
    """The packed tile's layout for sequences of N tokens of width D and H
    heads of Dh, z and the weights of ``z_size`` and ``w_size`` bytes
    (default: z's), or None where the cluster tile (`msa_plan`) runs.

    A layout only for fp32 z (fp32 or bf16 weights), N and Dh at most 32,
    and where a block's buffers fit two blocks an SM (`TWO_BLOCK_SMEM`):
    z [R rounded to 16][kp + pad] fp32 and the weights [kp][cols + pad],
    then Q, K and V [qrows][cols + 8] fp32; SA's staging [R][H Dh] fp32
    overlays z and the weights.  Each row is padded so that fragment loads
    hit distinct banks."""
    w_size = z_size if w_size is None else w_size
    if (z_size != 4 or not 1 <= n <= _PACKED_MAX_N
            or not 1 <= dh <= _PACKED_MAX_DH or d < 1 or h < 1):
        return None
    seqs = _PACKED_ROWS // n
    rows = seqs * n
    rm = _up(rows, 16)
    kp, dp = _up(d, 8), _up(dh, 8)
    ldz = kp + (8 if kp % 16 == 0 else 0)
    cols = _up(3 * h * dp, 16)
    ldw, ldq = cols + (4 if w_size == 4 else 8), cols + 8
    qrows = max(rm, (seqs - 1) * n + _up(n, 16))
    w_off = rm * ldz * 4
    qkv_off = _up(max(w_off + kp * ldw * w_size, rows * h * dh * 4), 16)
    smem = qkv_off + qrows * ldq * 4
    if smem > TWO_BLOCK_SMEM:
        return None
    return PackedPlan(seqs, rows, kp, ldz, dp, cols, ldw, ldq, qrows, w_off,
                      qkv_off, smem)


class AttentionPlan(NamedTuple):
    """One attention tile's layout, field for field csrc/attention.cuh's
    `AttLayout`, which the launch takes as is: ``rows`` query rows a
    block; ``dp`` is Dh padded to the tile's width and ``nk`` N padded to
    whole 64-key pages; ``lds``, ``ldk`` and ``ldv`` are the row strides
    (floats) of the scores, of Q and K pages, and of V pages; the ring has
    ``stages`` slots of ``stage`` bytes; the ``*_off`` are the byte
    offsets of Q (its TF32 parts, hi then lo, then the rows' maxima and
    reciprocal sums), the scores and the ring in a block's ``smem``
    bytes."""
    dp: int
    rows: int
    nk: int
    lds: int
    ldk: int
    ldv: int
    stage: int
    stages: int
    q_off: int
    s_off: int
    ring_off: int
    smem: int


@functools.lru_cache(maxsize=None)
def attention_plan(n: int, dh: int) -> AttentionPlan:
    """The attention tile's layout for N tokens of head width Dh (padded
    to DP 32, 64 or 128): Q of a
    32-row slice split into its TF32 parts (two [32][DP + 8]) and its
    rows' maxima and reciprocal sums (two [32]), its scores
    over all N keys [32][NK + 8] (at least P.V's partial sums of the key
    groups past the first: 8 / (DP / 16) groups of 16 values a lane of
    each 16-column block) and a ring of K or V pages ([64][DP + 8] or
    [64][DP + 4]), fp32, each row padded so that fragment loads hit
    distinct banks; three ring slots where two blocks of 256 threads still
    fit an SM, else two, else three at one block an SM.  Raises ValueError
    where Dh exceeds 128 or the layout exceeds one block's shared memory
    (N past 704 at Dh 65-128, 1,216 at Dh 33-64, 1,472 at Dh 32)."""
    dp = next((w for w in (32, 64, MAX_DH) if 1 <= dh <= w), 0)
    if dp == 0 or n < 1:
        raise ValueError(f"attention tile: no plan for N={n}, Dh={dh} "
                         f"(1 <= Dh <= {MAX_DH} and N >= 1 only)")
    nk = -(-n // _ATT_PAGE) * _ATT_PAGE
    lds, ldk, ldv = nk + 8, dp + 8, dp + 4
    col_blocks = dp // 16
    red = (_ATT_WARPS // col_blocks - 1) * 16 * col_blocks * 32
    qb, sb = 2 * ATT_ROWS * (ldk + 1) * 4, max(ATT_ROWS * lds, red) * 4
    stage = _ATT_PAGE * ldk * 4
    stages = next((s for s in _ATT_STAGES
                   if qb + sb + s * stage <= TWO_BLOCK_SMEM), _ATT_STAGES[0])
    smem = qb + sb + stages * stage
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention tile: N={n}, Dh={dh} needs {smem} "
                         f"bytes of shared memory a block, more than one "
                         f"block has ({SMEM_LIMIT})")
    return AttentionPlan(dp, ATT_ROWS, nk, lds, ldk, ldv, stage, stages,
                         q_off=0, s_off=qb, ring_off=qb + sb, smem=smem)


def window_operands(bias, mask, *, b: int, n: int, heads):
    """Check the windowed-mode operands, ``bias`` (*heads, N, N) with
    ``heads`` (H,) (a layer group's: (L, H)) and ``mask`` (nW, N, N), and
    return (bias, mask, nW); (None, None, 1) in global mode."""
    if (bias is None) != (mask is None):
        raise ValueError("windowed mode needs both bias and mask (pass a "
                         "zero mask for unshifted blocks)")
    if bias is None:
        return None, None, 1
    check(bias, "bias", torch.float32, (*heads, n, n))
    check(mask, "mask", torch.float32)
    n_w = mask.shape[0]
    if tuple(mask.shape) != (n_w, n, n) or n_w == 0 or b % n_w:
        raise ValueError(f"mask has shape {tuple(mask.shape)}; expected "
                         f"(nW, {n}, {n}) with nW dividing the batch {b}")
    return bias, mask, n_w


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, *, b: int, h: int, n: int, dh: int,
                     in_strides, out_strides,
                     out_scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact softmax(q.k^T * Dh**-0.5 [+ bias[h] + mask[i % nW]]).v per
    (image, head) on the current stream, laid out by `attention_plan`.
    ``in_strides``/``out_strides`` are the (image, token, head) element
    strides of q/k/v and of ``out``; element e is contiguous.  ``out`` is
    float32, int8 quantised at ``out_scale``, or bf16 (the float MSA's
    bf16 mode: P rounded to bf16 before the product, v bf16-exact)."""
    for t, nm in ((q, "q"), (k, "k"), (v, "v")):
        check(t, nm, torch.float32)
    bf16 = out_scale is None and out.dtype == torch.bfloat16
    check(out, "out", torch.int8 if out_scale is not None
          else torch.bfloat16 if bf16 else torch.float32)
    if out_scale is not None:
        check(out_scale, "out_scale", torch.float32, (1,))
    bias, mask, n_w = window_operands(bias, mask, b=b, n=n, heads=(h,))
    plan = attention_plan(n, dh)
    sb, sn, sh = in_strides
    ob, on, oh = out_strides
    build.call("attention", "rt_attention", ptr(q), ptr(k), ptr(v), sb, sn,
               sh, ptr(out), ob, on, oh, b, h, n, dh, dh ** -0.5,
               ptr(out_scale), ptr(bias), ptr(mask), n_w, int(bf16),
               build.ints(plan), stream())
    return out


def launch_msa(z: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
               wv: torch.Tensor, out: torch.Tensor, out_strides, *,
               bias=None, mask=None, qkv_bias=None) -> torch.Tensor:
    """csrc/vita_msa.cu on the current stream: z (B, N, D) and the (H, D,
    Dh) weight stacks (a mode of `ref.PORTED_MODES`) into ``out`` of z's
    dtype, element e of (image, token, head) at out[b*ob + n*on + h*oh +
    e] for ``out_strides`` (ob, on, oh).  Windowed mode takes ``bias``
    (H, N, N) and ``mask`` (nW, N, N) in float32; ``qkv_bias`` (3, H, Dh),
    in the weights' dtype, is optional.  Where `msa_packed_plan` gives a
    layout the packed tile runs; otherwise `msa_plan`'s, and a paged plan
    takes two launches: the projection into Q, K, V workspace (fp32, V
    rounded to z's type), then `launch_attention`.

    While tracing is on, each call counts the query rows it is given, B
    H N (``kernels.msa_rows``), and the rows its blocks span, B H times
    the ``cluster`` x ``rows`` of its `msa_plan`
    (``kernels.msa_tile_rows``): their ratio is the tile's padding.  On
    the packed route the blocks span ceil(B / seqs) x ``rows`` x H, and
    the query rows it is given count again as
    ``kernels.msa_packed_rows``, so ``msa_packed_rows / msa_rows`` is the
    share it takes.  All come from shapes on the host."""
    b, n, d = z.shape
    h, _, dh = wq.shape
    wt = check_mode("vita_msa_batched", z, wq, wk, wv, qkv_bias)
    check(z, "z", z.dtype)
    for w, nm in ((wq, "wq"), (wk, "wk"), (wv, "wv")):
        check(w, nm, wt, (h, d, dh))
    if qkv_bias is not None:
        check(qkv_bias, "qkv_bias", wt, (3, h, dh))
    check(out, "out", z.dtype)
    bias, mask, n_w = window_operands(bias, mask, b=b, n=n, heads=(h,))
    packed = msa_packed_plan(n, d, h, dh, z.element_size(),
                             wq.element_size())
    if packed is not None:
        if _trace.ON:
            _trace.count(_COUNT_ROWS, b * h * n)
            _trace.count(_COUNT_TILE_ROWS,
                         -(-b // packed.seqs) * packed.rows * h)
            _trace.count(_COUNT_PACKED_ROWS, b * h * n)
        build.call("vita_msa", "rt_vita_msa_packed", ptr(z), ptr(wq),
                   ptr(wk), ptr(wv), ptr(qkv_bias), ptr(bias), ptr(mask),
                   n_w, ptr(out), *out_strides, b, n, d, h, dh, dh ** -0.5,
                   DTYPE_CODES[z.dtype], DTYPE_CODES[wt],
                   build.ints(packed), stream())
        return out
    plan = msa_plan(n, dh, z.element_size(), wq.element_size())
    if _trace.ON:
        _trace.count(_COUNT_ROWS, b * h * n)
        _trace.count(_COUNT_TILE_ROWS, b * h * plan.cluster * plan.rows)
    ints = build.ints(plan)
    if plan.paged:
        hd = h * dh
        qkv = torch.empty((3, b * n, hd), device=z.device,
                          dtype=torch.float32)
        build.call("vita_msa", "rt_msa_project", ptr(z), ptr(wq), ptr(wk),
                   ptr(wv), ptr(qkv_bias), ptr(qkv[0]), ptr(qkv[1]),
                   ptr(qkv[2]), b, n, d, h, dh, DTYPE_CODES[z.dtype],
                   DTYPE_CODES[wt], ints, stream())
        return launch_attention(*qkv, out, b=b, h=h, n=n, dh=dh,
                                in_strides=(n * hd, hd, dh),
                                out_strides=out_strides, bias=bias,
                                mask=mask)
    build.call("vita_msa", "rt_vita_msa", ptr(z), ptr(wq), ptr(wk), ptr(wv),
               ptr(qkv_bias), ptr(bias), ptr(mask), n_w, ptr(out),
               *out_strides, b, n, d, h, dh, dh ** -0.5,
               DTYPE_CODES[z.dtype], DTYPE_CODES[wt], ints, stream())
    return out


def vita_msa_batched(z: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                     wv: torch.Tensor, bias=None, mask=None,
                     qkv_bias=None) -> torch.Tensor:
    """z (B, N, D); wq/wk/wv (H, D, Dh) -> (B, H, N, Dh) in z's dtype, on
    the card; (z, weights) float32 / float32, float32 / bf16 or bf16 /
    bf16.  Windowed mode takes ``bias`` (H, N, N) and ``mask`` (nW, N, N)
    in float32; ``qkv_bias`` (3, H, Dh), in the weights' dtype, is
    optional."""
    b, n, _ = z.shape
    h, _, dh = wq.shape
    out = torch.empty((b, h, n, dh), device=z.device, dtype=z.dtype)
    return launch_msa(z, wq, wk, wv, out, (h * n * dh, dh, n * dh),
                      bias=bias, mask=mask, qkv_bias=qkv_bias)


def vita_msa(z: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor) -> torch.Tensor:
    """One image: z (N, D) -> (H, N, Dh), on the card."""
    return vita_msa_batched(z[None], wq, wk, wv)[0]


def vita_msa_int8(z_q: torch.Tensor, wq_q: torch.Tensor, wk_q: torch.Tensor,
                  wv_q: torch.Tensor, x_scale: torch.Tensor,
                  wq_scale: torch.Tensor, wk_scale: torch.Tensor,
                  wv_scale: torch.Tensor, bias=None, mask=None,
                  qkv_bias=None) -> torch.Tensor:
    """z_q (B, N, D) int8; w*_q (H, D, Dh) int8; x_scale scalar float32;
    w*_scale (H, Dh) float32 -> (B, H, N, Dh) float32, on the card.  The
    float32 or bf16 ``qkv_bias`` (3, H, Dh) joins in the GEMM epilogue,
    after the requant; ``bias``/``mask`` select the windowed mode."""
    b, n, d = z_q.shape
    h, _, dh = wq_q.shape
    check(z_q, "z_q", torch.int8)
    if qkv_bias is not None:
        check(qkv_bias, "qkv_bias", qkv_bias.dtype, (3, h, dh))
    xs = x_scale.reshape(1)
    z2 = z_q.reshape(b * n, d)
    proj = []
    for i, (w, ws) in enumerate(((wq_q, wq_scale), (wk_q, wk_scale),
                                 (wv_q, wv_scale))):
        check(w, "w", torch.int8, (h, d, dh))
        out = torch.empty((b * n, h * dh), device=z_q.device,
                          dtype=torch.float32)
        proj.append(launch_gemm_i8(
            z2, w, out, x_scale=xs, w_scale=ws.reshape(h * dh),
            bias=None if qkv_bias is None else qkv_bias[i].reshape(h * dh)))
    out = torch.empty((b, h, n, dh), device=z_q.device, dtype=torch.float32)
    return launch_attention(*proj, out, b=b, h=h, n=n, dh=dh,
                            in_strides=(n * h * dh, h * dh, dh),
                            out_strides=(h * n * dh, dh, n * dh),
                            bias=bias, mask=mask)
