"""Per-head MSA on Hopper: the int8 PTQ variant of the unfused executor.

Counterpart of `repro/kernels/vita_msa.py`: `vita_msa_int8` replaces the
(B, H)-grid Pallas kernel of the same name, which the int8 calibration
pass runs.  On the card it is three int8 GEMMs (``csrc/gemm_i8.cu``) that
project Q, K and V with the per-(head, channel) requant in their epilogue,
reading the (H, D, Dh) weight stacks in place, then the attention kernel
``csrc/attention.cu``.  `launch_attention` is the building block the fused
layer reuses.  Windowed mode and ``qkv_bias`` are not ported yet.  These
functions take CUDA tensors only; the plain version is
`ref.vita_msa_int8_ref`, chosen by `ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .int8_matmul import _stream, check, launch_gemm_i8, ptr


def launch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, *, b: int, h: int, n: int, dh: int,
                     in_strides, out_strides,
                     out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact softmax(q.k^T * Dh**-0.5).v per (image, head) on the current
    stream.  ``in_strides``/``out_strides`` are the (image, token, head)
    element strides of q/k/v and of ``out``; element e is contiguous.
    ``out`` is float32, or int8 quantised at ``out_scale``."""
    for t, nm in ((q, "q"), (k, "k"), (v, "v")):
        check(t, nm, torch.float32)
    check(out, "out", torch.int8 if out_scale is not None else torch.float32)
    if out_scale is not None:
        check(out_scale, "out_scale", torch.float32, (1,))
    sb, sn, sh = in_strides
    ob, on, oh = out_strides
    build.call("attention", "rt_attention", ptr(q), ptr(k), ptr(v), sb, sn,
               sh, ptr(out), ob, on, oh, b, h, n, dh, dh ** -0.5,
               ptr(out_scale), _stream())
    return out


def vita_msa_int8(z_q: torch.Tensor, wq_q: torch.Tensor, wk_q: torch.Tensor,
                  wv_q: torch.Tensor, x_scale: torch.Tensor,
                  wq_scale: torch.Tensor, wk_scale: torch.Tensor,
                  wv_scale: torch.Tensor, bias=None, mask=None,
                  qkv_bias=None) -> torch.Tensor:
    """z_q (B, N, D) int8; w*_q (H, D, Dh) int8; x_scale scalar float32;
    w*_scale (H, Dh) float32 -> (B, H, N, Dh) float32, on the card."""
    if bias is not None or mask is not None or qkv_bias is not None:
        raise NotImplementedError(
            "windowed mode and qkv_bias are not ported yet")
    b, n, d = z_q.shape
    h, _, dh = wq_q.shape
    check(z_q, "z_q", torch.int8)
    xs = x_scale.reshape(1)
    z2 = z_q.reshape(b * n, d)
    proj = []
    for w, ws in ((wq_q, wq_scale), (wk_q, wk_scale), (wv_q, wv_scale)):
        check(w, "w", torch.int8, (h, d, dh))
        out = torch.empty((b * n, h * dh), device=z_q.device,
                          dtype=torch.float32)
        proj.append(launch_gemm_i8(z2, w, out, x_scale=xs,
                                   w_scale=ws.reshape(h * dh)))
    out = torch.empty((b, h, n, dh), device=z_q.device, dtype=torch.float32)
    return launch_attention(*proj, out, b=b, h=h, n=n, dh=dh,
                            in_strides=(n * h * dh, h * dh, dh),
                            out_strides=(h * n * dh, dh, n * dh))
