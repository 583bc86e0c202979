"""The fused GELU MLP on Hopper (counterpart of
`repro/kernels/fused_mlp.py::fused_mlp`).

One launch of ``csrc/fused_mlp.cu`` computes gelu(x W1 + b1) W2 + b2 with
the hidden activation streamed through shared memory in 64-wide chunks:
it never reaches device memory.  Only the ungated GELU MLP of the vision
path is ported; the other activations, the gate and non-float32 inputs
raise.  This function takes CUDA tensors only; the plain version is
`ref.fused_mlp_ref`, chosen by `ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .int8_matmul import _stream, check, ptr
from .ref import fp32_only, gelu_mlp_only
from .vita_msa import SMEM_LIMIT

_STATIC_SMEM_MAX = 4 * (16 * 64 + 16 * 64 + 16 * 256)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              b1: Optional[torch.Tensor] = None,
              b2: Optional[torch.Tensor] = None,
              w_gate: Optional[torch.Tensor] = None, *,
              activation: str = "gelu") -> torch.Tensor:
    """x (..., D); w1 (D, M); w2 (M, D_out); b1 (M,); b2 (D_out,) ->
    (..., D_out) float32, on the card."""
    gelu_mlp_only(activation, w_gate)
    fp32_only("fused_mlp", x, w1, w2, b1, b2)
    d = x.shape[-1]
    m, d_out = w2.shape
    check(x, "x", torch.float32)
    check(w1, "w1", torch.float32, (d, m))
    check(w2, "w2", torch.float32, (m, d_out))
    if b1 is not None:
        check(b1, "b1", torch.float32, (m,))
    if b2 is not None:
        check(b2, "b2", torch.float32, (d_out,))
    if 4 * 16 * (-(-d // 16) * 16) + _STATIC_SMEM_MAX > SMEM_LIMIT:
        raise ValueError(f"fused_mlp: D={d} rows do not fit in one block's "
                         f"shared memory")
    rows = x.numel() // d
    out = torch.empty((*x.shape[:-1], d_out), device=x.device,
                      dtype=torch.float32)
    if rows == 0:
        return out
    build.call("fused_mlp", "rt_fused_mlp", ptr(x), ptr(w1), ptr(b1),
               ptr(w2), ptr(b2), ptr(out), rows, d, m, d_out, _stream())
    return out
