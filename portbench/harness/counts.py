"""The yardstick's arithmetic: the chip's peaks, the operations an image
needs, and the operations and bytes of one call of kernel 1 (the fused
float encoder layer, `ops.vita_layer_fused`).

Peaks are NVIDIA's published dense rates for one H100 SXM at 700 W.
float32 operands are priced at the TF32 tensor-core rate, the fastest
route the card has for them, so no fp32-accurate route can read over
100%.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

TF32_FLOP_S = 495e12          # dense TF32 tensor cores
HBM_BYTES_S = 3.35e12         # HBM3


def _stage_macs(tokens: int, windows: int, dim: int, heads: int,
                mlp_ratio: float, layers: int) -> int:
    """Per-image MACs of ``layers`` encoder blocks over ``windows`` windows
    of ``tokens`` tokens: Q/K/V, Q K^T, P V, the output projection, the
    MLP (as the program's `core/perfmodel.py` counts them)."""
    dh = dim // heads
    hidden = int(dim * mlp_ratio)
    msa = ((3 * tokens * dim * dh + 2 * tokens * tokens * dh) * heads
           + tokens * heads * dh * dim) * windows
    mlp = 2 * tokens * windows * dim * hidden
    return layers * (msa + mlp)


def macs_per_image(family: str, s: Mapping[str, Any]) -> int:
    """Multiply-accumulates one image needs: the patch embedding, every
    encoder block and Swin's patch merges.  The head (D x classes) and
    the elementwise work are left out."""
    p = s["patch"]
    side = s["image"] // p
    if family == "vit":
        d = s["dim"]
        return side * side * 3 * p * p * d + _stage_macs(
            side * side, 1, d, s["heads"], s["mlp_ratio"], s["layers"])
    if family == "swin":
        win, dim = s["window"], s["embed_dim"]
        total = side * side * 3 * p * p * dim
        n_stages = len(s["depths"])
        for i, (depth, heads) in enumerate(zip(s["depths"], s["heads"])):
            total += _stage_macs(win * win, (side // win) ** 2, dim, heads,
                                 s["mlp_ratio"], depth)
            if i < n_stages - 1:
                total += (side // 2) ** 2 * (4 * dim) * (2 * dim)
                side //= 2
                dim *= 2
        return total
    raise ValueError(f"no operation count for family {family!r}")


def flops_per_image(family: str, sizes: Mapping[str, Any]) -> int:
    return 2 * macs_per_image(family, sizes)


def vita_layer_call(x_shape: Tuple[int, ...], heads: int, head_dim: int,
                    hidden: int, bias_elems: int = 0, mask_elems: int = 0,
                    elem_bytes: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of one kernel-1 call on x (B', N, D): the
    products 2 B' N (3 D H Dh + H Dh D + 2 D M) and attention 4 B' H N^2
    Dh; every input read once (x, the weights, LayerNorm vectors, biases,
    a window bias and mask) and the output written once."""
    b, n, d = x_shape
    hd = heads * head_dim
    ops = 2 * b * n * (3 * d * hd + hd * d + 2 * d * hidden) \
        + 4 * b * heads * n * n * head_dim
    weights = 3 * d * hd + hd * d + 2 * d * hidden + 4 * d + hidden + d
    elems = 2 * b * n * d + weights + bias_elems + mask_elems
    return ops, elems * elem_bytes


def least_time_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    at the TF32 peak and the bytes at the memory rate."""
    return max(ops / TF32_FLOP_S, nbytes / HBM_BYTES_S)


def share_pct(least_s: float, took_s: float) -> Optional[float]:
    return None if took_s <= 0 else 100.0 * least_s / took_s
