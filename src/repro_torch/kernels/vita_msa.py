"""Per-head MSA on Hopper: the unfused executor's float and int8 kernels.

Counterpart of `repro/kernels/vita_msa.py`.

  * `vita_msa_batched` / `vita_msa` replace the float (B, H)-grid Pallas
    kernel: one launch of ``csrc/vita_msa.cu`` projects Q, K and V and
    attends with all three kept in shared memory, so SA is the only tensor
    it writes.  z and the weights are float32 or bf16 (`ref.PORTED_MODES`);
    with bf16 z it rounds P and V to bf16 before the AV product, as the TPU
    kernel does, and writes SA in z's dtype.
  * `vita_msa_int8` replaces the int8 kernel of the calibration pass and
    the unfused int8 executor: three int8 GEMMs (``csrc/gemm_i8.cu``)
    project Q, K and V with the per-(head, channel) requant (and the
    optional ``qkv_bias``) in their epilogue, reading the (H, D, Dh) weight
    stacks in place, then the attention kernel ``csrc/attention.cu``.

All of them take the windowed (Swin) mode: the caller folds windows into
the batch axis and passes ``bias`` (H, N, N) and ``mask`` (nW, N, N).
`launch_attention` is the building block the fused layers reuse.  These
functions take CUDA tensors only; the plain versions in `ref` are chosen
by `ops` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .int8_matmul import DTYPE_CODES, _stream, check, launch_gemm_i8, ptr
from .ref import check_mode

# Shared memory one block may use on an H100 (bytes), and the static
# staging buffers of csrc/vita_msa.cu that come out of it.
SMEM_LIMIT = 232448
_MSA_STATIC_SMEM = 2 * 16 * 64 * 4


def msa_smem_bytes(n: int, dh: int, z_size: int = 4) -> int:
    """Dynamic shared memory of one csrc/vita_msa.cu block (its
    `msa_smem_bytes`): K [N][Dh+1], a 32-row Q tile and 8 score rows of N
    in fp32, and V [N][Dh] in z's type (``z_size`` bytes: bf16 halves
    it)."""
    return 4 * (n * (dh + 1) + 32 * dh + 8 * n) + z_size * n * dh


def window_operands(bias, mask, *, b: int, h: int, n: int):
    """Check the windowed-mode operands and return (bias, mask, nW);
    (None, None, 1) in global mode."""
    if (bias is None) != (mask is None):
        raise ValueError("windowed mode needs both bias and mask (pass a "
                         "zero mask for unshifted blocks)")
    if bias is None:
        return None, None, 1
    check(bias, "bias", torch.float32, (h, n, n))
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
    (image, head) on the current stream.  ``in_strides``/``out_strides``
    are the (image, token, head) element strides of q/k/v and of ``out``;
    element e is contiguous.  ``out`` is float32, or int8 quantised at
    ``out_scale``."""
    for t, nm in ((q, "q"), (k, "k"), (v, "v")):
        check(t, nm, torch.float32)
    check(out, "out", torch.int8 if out_scale is not None else torch.float32)
    if out_scale is not None:
        check(out_scale, "out_scale", torch.float32, (1,))
    bias, mask, n_w = window_operands(bias, mask, b=b, h=h, n=n)
    sb, sn, sh = in_strides
    ob, on, oh = out_strides
    build.call("attention", "rt_attention", ptr(q), ptr(k), ptr(v), sb, sn,
               sh, ptr(out), ob, on, oh, b, h, n, dh, dh ** -0.5,
               ptr(out_scale), ptr(bias), ptr(mask), n_w, _stream())
    return out


def vita_msa_batched(z: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                     wv: torch.Tensor, bias=None, mask=None,
                     qkv_bias=None) -> torch.Tensor:
    """z (B, N, D); wq/wk/wv (H, D, Dh) -> (B, H, N, Dh) in z's dtype, on
    the card; (z, weights) float32 / float32, float32 / bf16 or bf16 /
    bf16.  Windowed mode takes ``bias`` (H, N, N) and ``mask`` (nW, N, N)
    in float32; ``qkv_bias`` (3, H, Dh), in the weights' dtype, is
    optional."""
    b, n, d = z.shape
    h, _, dh = wq.shape
    wt = check_mode("vita_msa_batched", z, wq, wk, wv, qkv_bias)
    check(z, "z", z.dtype)
    for w, nm in ((wq, "wq"), (wk, "wk"), (wv, "wv")):
        check(w, nm, wt, (h, d, dh))
    if qkv_bias is not None:
        check(qkv_bias, "qkv_bias", wt, (3, h, dh))
    bias, mask, n_w = window_operands(bias, mask, b=b, h=h, n=n)
    if msa_smem_bytes(n, dh, z.element_size()) + _MSA_STATIC_SMEM \
            > SMEM_LIMIT:
        raise ValueError(f"vita_msa_batched: N={n}, Dh={dh} needs more "
                         f"shared memory than one block has")
    out = torch.empty((b, h, n, dh), device=z.device, dtype=z.dtype)
    build.call("vita_msa", "rt_vita_msa", ptr(z), ptr(wq), ptr(wk), ptr(wv),
               ptr(qkv_bias), ptr(bias), ptr(mask), n_w, ptr(out), b, n, d,
               h, dh, dh ** -0.5, DTYPE_CODES[z.dtype], DTYPE_CODES[wt],
               _stream())
    return out


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
