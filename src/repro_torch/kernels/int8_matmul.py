"""int8 x int8 -> int32 matmul with fused requantisation, on Hopper.

Counterpart of `repro/kernels/int8_matmul.py::int8_matmul` (a tiled MXU
product with x_scale * w_scale[n] fused into its last k-step).  The CUDA
kernel is ``csrc/gemm_i8.cu``; its source note says what bounds it and how
its design differs from the TPU's.  `launch_gemm_i8` is the building block
the fused int8 layer and the int8 MSA compose; `int8_matmul` keeps the JAX
function's argument layout.  These functions take CUDA tensors only: the
plain version for the CPU is `ref.int8_matmul_ref`, chosen by `ops`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


# Element-type codes of the kernels' C interfaces (csrc/common.cuh's
# ElemCode).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: float32 or bfloat16 inputs only, got "
                        f"{t.dtype}")
    return DTYPE_CODES[t.dtype]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def b_layout(w: torch.Tensor):
    """(K, N, ldb, grp, grp_stride) of a GEMM's B operand: a plain (K, N)
    matrix, or a per-head (H, K, Dh) stack read in place as the (K, H*Dh)
    matrix whose column h*Dh + e is w[h, :, e]."""
    if w.dim() == 2:
        k, n = w.shape
        return k, n, n, n, 0
    h, k, dh = w.shape
    return k, h * dh, dh, dh, k * dh


_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.int8: 2}


def launch_gemm_i8(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, *,
                   x_scale: Optional[torch.Tensor] = None,
                   w_scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   res: Optional[torch.Tensor] = None, gelu: bool = False,
                   out_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out (M, N) = epilogue(a (M, K) int8 . w int8) on the current stream.

    ``out``'s dtype picks the epilogue: int32 is the raw accumulator;
    float32 is acc * (x_scale * w_scale[n]) [+ bias] [-> gelu] [res +];
    int8 is that float quantised at ``out_scale``.  Scales are float32
    device tensors (x_scale and out_scale hold one value); the bias is
    float32 or bf16 (a bf16 model's PTQ keeps its biases bf16)."""
    k, n, ldb, grp, grp_stride = b_layout(w)
    m = a.shape[0]
    check(a, "a", torch.int8, (m, k))
    check(w, "w", torch.int8)
    check(out, "out", out.dtype, (m, n))
    kind = _OUT_KIND[out.dtype]
    bias_code = 0 if bias is None else dtype_code("bias", bias)
    for t, nm, numel in ((x_scale, "x_scale", 1), (w_scale, "w_scale", n),
                         (bias, "bias", n), (out_scale, "out_scale", 1)):
        if t is not None:
            check(t, nm, bias.dtype if t is bias else torch.float32)
            if t.numel() != numel:
                raise ValueError(
                    f"{nm} has {t.numel()} values, expected {numel}")
    if res is not None:
        check(res, "res", torch.float32, (m, n))
    if kind == 2 and out_scale is None:
        raise ValueError("an int8 output needs out_scale")
    build.call("gemm_i8", "rt_gemm_i8", ptr(a), k, ptr(w), ldb, grp,
               grp_stride, ptr(out), n, kind, m, n, k, ptr(x_scale),
               ptr(w_scale), ptr(bias), ptr(res), n, int(gelu),
               ptr(out_scale), bias_code, _stream())
    return out


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                x_scale: Optional[torch.Tensor] = None,
                w_scale: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x_q (M, K) int8 . w_q (K, N) int8 on the card.

    Without scales returns the int32 product; with a scalar ``x_scale``
    and/or an (N,) ``w_scale`` returns the rescaled float32."""
    if w_q.dim() != 2:
        raise ValueError("w_q must be (K, N)")
    scaled = x_scale is not None or w_scale is not None
    if out_dtype not in (None, torch.int32 if not scaled else torch.float32):
        raise TypeError(
            f"out_dtype {out_dtype} is not produced by this kernel")
    out = torch.empty((x_q.shape[0], w_q.shape[1]), device=x_q.device,
                      dtype=torch.float32 if scaled else torch.int32)
    return launch_gemm_i8(
        x_q, w_q, out,
        x_scale=None if x_scale is None else x_scale.reshape(1),
        w_scale=None if w_scale is None else w_scale.reshape(-1))
