"""The RG-LRU linear recurrence on Hopper (counterpart of
`repro/kernels/rglru_scan.py::rglru_scan`).

One launch of ``csrc/rglru_scan.cu`` computes h_t = a_t h_{t-1} + b_t
along T of (B, T, W) with h carried in float32, one thread per
(sequence, channel).  This function takes CUDA tensors only; the plain
version is `ref.linear_recurrence_ref`, chosen by `ops`.
"""

from __future__ import annotations

import torch

from . import build
from .int8_matmul import _stream, check, dtype_code, ptr


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, T, W) float32 or bfloat16 -> h (B, T, W) in a's dtype."""
    code = dtype_code("rglru_scan", a)
    check(a, "a", a.dtype)
    check(b, "b", a.dtype, tuple(a.shape))
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a must be (B, T, W), got "
                         f"{tuple(a.shape)}")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    bsz, t, w = a.shape
    build.call("rglru_scan", "rt_rglru_scan", ptr(a), ptr(b), ptr(out), bsz,
               t, w, code, _stream())
    return out
