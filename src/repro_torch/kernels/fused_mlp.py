"""The fused MLP on Hopper (counterpart of
`repro/kernels/fused_mlp.py::fused_mlp`).

One call computes act(x W1 + b1) W2 + b2, or the gated
act(x Wg) * (x W1 + b1) W2 + b2, with the hidden activation streamed
through shared memory in 64-wide chunks: it never reaches device memory.
Every activation of `ref.ACTIVATIONS`; x (and out) float32 or bfloat16,
the weights and biases float32 or bfloat16 (`ref.PORTED_MODES`: float32
x with bf16 weights is a bf16 vision model served on float32 images),
float32 sums, the hidden chunk rounded to x's dtype before the second
product.  The launch plan picks a regime from the row count:

  * at most ``FEW_ROWS`` rows (a decode step, a short prompt):
    ``csrc/fused_mlp.cu``, bound by the weights' bytes: each block
    computes a range of hidden chunks once for every output column and
    writes an fp32 partial, which a second kernel adds in order;
  * more rows (vision tokens): ``csrc/fused_mlp_rows.cu``, a 64-row tile
    on the bf16 tensor cores (fp32 FMAs for fp32 x), with a hidden split
    where its tiles leave SMs idle.

`hidden_splits` is the plan's count of fp32 partials.  This function
takes CUDA tensors only; the plain version is `ref.fused_mlp_ref`,
chosen by `ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .build import DTYPE_CODES, check, dtype_code, ptr, stream
from .ref import ACTIVATION_CODES, act_fn, check_mode


FEW_ROWS = 16     # the few-rows regime's largest row count


def _library(rows: int) -> str:
    return "fused_mlp" if rows <= FEW_ROWS else "fused_mlp_rows"


def hidden_splits(rows: int, d: int, m: int, d_out: int, code: int,
                  requested: int = 0) -> int:
    """The hidden splits the plan makes for ``rows`` rows (1: no partial;
    each split writes a float32 (rows, d_out) partial).  ``requested`` > 0
    asks for about that many instead (the fewest the kernel takes at 1),
    which measures what the split buys."""
    lib = _library(rows)
    return build.query(lib, f"rt_{lib}_splits", rows, d, m, d_out, code,
                       requested)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              b1: Optional[torch.Tensor] = None,
              b2: Optional[torch.Tensor] = None,
              w_gate: Optional[torch.Tensor] = None, *,
              activation: str = "gelu") -> torch.Tensor:
    """x (..., D); w1, w_gate (D, M); w2 (M, D_out); b1 (M,); b2 (D_out,),
    the weights of one dtype -> (..., D_out) in x's dtype, on the card."""
    act_fn(activation)
    code = dtype_code("fused_mlp", x)
    wt = check_mode("fused_mlp", x, w1, w2, b1, b2, w_gate)
    d = x.shape[-1]
    m, d_out = w2.shape
    check(x, "x", x.dtype)
    check(w1, "w1", wt, (d, m))
    check(w2, "w2", wt, (m, d_out))
    if w_gate is not None:
        check(w_gate, "w_gate", wt, (d, m))
    if b1 is not None:
        check(b1, "b1", wt, (m,))
    if b2 is not None:
        check(b2, "b2", wt, (d_out,))
    rows = x.numel() // d
    out = torch.empty((*x.shape[:-1], d_out), device=x.device,
                      dtype=x.dtype)
    if rows == 0:
        return out
    splits = hidden_splits(rows, d, m, d_out, code)
    partial = None if splits == 1 else torch.empty(
        (splits, rows, d_out), device=x.device, dtype=torch.float32)
    lib = _library(rows)
    build.call(lib, f"rt_{lib}", ptr(x), ptr(w1), ptr(b1), ptr(w_gate),
               ptr(w2), ptr(b2), ptr(out), ptr(partial), rows, d, m, d_out,
               ACTIVATION_CODES[activation], splits, code, DTYPE_CODES[wt],
               stream())
    return out
