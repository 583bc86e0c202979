"""int8 x int8 -> int32 matmul with fused requantisation, on Hopper.

Counterpart of `repro/kernels/int8_matmul.py::int8_matmul` (a tiled MXU
product with x_scale * w_scale[n] fused into its last k-step).  The CUDA
kernel is ``csrc/gemm_i8.cu`` over the int8 tensor-core tile
``csrc/mma_gemm_i8.cuh`` (`mma.sync` m16n8k32); its source note says what
bounds it and how its design differs from the TPU's.  `gemm_i8_plan`
chooses its tile and copy widths, and the launch takes the plan as is.
`launch_gemm_i8` is the building block the fused int8 layer and the int8
MSA compose; `int8_matmul` keeps the JAX function's argument layout.
These functions take CUDA tensors only: the plain version for the CPU is
`ref.int8_matmul_ref`, chosen by `ops`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .build import check, dtype_code, ptr, sm_count, stream


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

# csrc/gemm_i8.cu's output tile (rows, columns), the k groups it is built
# for, its ring's stages and their depth in k (bytes), and the copy widths
# (bytes) a stage may use.
I8_TILE, I8_KGROUPS = (64, 64), (1, 2)
I8_STAGES, I8_BK = 4, 128
_WIDTHS = (16, 8, 4, 1)


class I8Plan(NamedTuple):
    """One csrc/gemm_i8.cu launch: a ``bm`` x ``bn`` output tile a block
    (``threads``: a warp per 32 x 32 for each of ``kgroups`` warp groups
    that split the k steps), a ring of ``stages`` stages 128 deep in k
    (``smem`` bytes), A and B copied in chunks of ``a_chunk`` and
    ``b_chunk`` bytes (16: one 16-byte cp.async; 8 or 4: narrower ones; 1:
    byte by byte), and ``tiles`` blocks, ``waves`` tiles an SM at most."""
    bm: int
    bn: int
    kgroups: int
    threads: int
    stages: int
    a_chunk: int
    b_chunk: int
    smem: int
    tiles: int
    waves: int

    def launch_ints(self):
        """The six ints the C entry takes (csrc/gemm_i8.cu's I8Layout)."""
        return (self.bm, self.bn, self.kgroups, self.stages, self.a_chunk,
                self.b_chunk)


def _width(*values: int) -> int:
    """The widest copy chunk (16, 8, 4 or 1 bytes) that divides every one
    of ``values``."""
    return next(w for w in _WIDTHS if all(v % w == 0 for v in values))


@functools.lru_cache(maxsize=None)
def gemm_i8_plan(m: int, n: int, k: int, *, ldb: int, grp: int,
                 grp_stride: int, a_align: int = 0, b_align: int = 0,
                 sms: int = 132, kgroups=None) -> I8Plan:
    """The plan of an (m, k) . (k, n) int8 product whose A rows are k
    bytes and whose B element (k, j) is B[(j // grp) * grp_stride + k * ldb
    + j % grp] (a plain (K, N) matrix: grp = ldb = n; a per-head (H, K,
    Dh) stack: grp = ldb = Dh, grp_stride = K * Dh); ``a_align`` and
    ``b_align`` are the operands' addresses modulo 16.

    Each tile's k steps are split over two warp groups where the tiles
    are no more than the ``sms`` SMs (one block an SM: the second group
    takes an idle SM's place), else run by one, which keeps the blocks
    small enough for several to share an SM (``kgroups`` forces either:
    what chip_smoke.py measures the choice by).  A chunk of B is 16 bytes
    only where it stays inside one head (grp % 16 == 0) and every row and
    head starts aligned, else the widest width that does (8 or 4; 1 where
    none does); A's likewise within a row."""
    bm, bn = I8_TILE
    tiles = -(-m // bm) * -(-n // bn)
    kg = kgroups or (2 if tiles <= sms else 1)
    if kg not in I8_KGROUPS:
        raise ValueError(f"int8 GEMM: no kernel for {kg} k groups (built: "
                         f"{I8_KGROUPS})")
    smem = max(I8_STAGES * (bm * (I8_BK + 16) + I8_BK * bn),
               (kg - 1) * bm * bn * 4)
    return I8Plan(bm, bn, kg, bm * bn * kg // 32, I8_STAGES,
                  _width(k, a_align), _width(ldb, grp, grp_stride, n,
                                             b_align), smem, tiles,
                  -(-tiles // sms))


def plan_for(a: torch.Tensor, w: torch.Tensor) -> I8Plan:
    """`gemm_i8_plan` of a (M, K) int8 against ``w`` ((K, N) or a per-head
    (H, K, Dh) stack, `b_layout`) on their card."""
    k, n, ldb, grp, grp_stride = b_layout(w)
    return gemm_i8_plan(a.shape[0], n, k, ldb=ldb, grp=grp,
                        grp_stride=grp_stride, a_align=a.data_ptr() % 16,
                        b_align=w.data_ptr() % 16,
                        sms=sm_count(a.device.index or 0))


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
    plan = plan_for(a, w).launch_ints()
    build.call("gemm_i8", "rt_gemm_i8", ptr(a), k, ptr(w), ldb, grp,
               grp_stride, ptr(out), n, kind, m, n, k, ptr(x_scale),
               ptr(w_scale), ptr(bias), ptr(res), n, int(gelu),
               ptr(out_scale), bias_code, build.ints(plan), stream())
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
