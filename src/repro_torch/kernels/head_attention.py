"""LM attention on Hopper (counterpart of
`repro/kernels/head_attention.py`): `flash_attention` for prefill and
`decode_attention` for one query per sequence over a KV cache.

`flash_attention` launches ``csrc/flash_attention.cu`` over the
online-softmax tile of ``csrc/head_attention.cuh``; `decode_attention`
launches ``csrc/decode_attention.cu``, split over the cache
(flash-decoding: `decode_splits` key ranges per KV head, combined in
split order by a second kernel) with the K/V tiles streamed by
asynchronous copies.  Their source notes say what bounds them.
float32 or bfloat16 in and out, float32 sums; head_dim up to 256.  These
functions take CUDA tensors only; the plain versions are
`ref.attention_ref` and `ref.decode_attention_ref`, chosen by `ops`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .int8_matmul import _stream, check, dtype_code, ptr

MAX_HEAD_DIM = 256
MAX_GROUP = 16        # query rows of one decode tile (Hq / Hkv)


def _heads(name: str, hq: int, hkv: int, dh: int) -> None:
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: {hq} query heads do not group over {hkv} "
                         f"KV heads")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {dh} outside 1..{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, Nq, Dh); k, v (B, Hkv, Nk, Dh) -> (B, Hq, Nq, Dh) in q's
    dtype, on the card.  Query i sits at position i + ``q_offset``."""
    code = dtype_code("flash_attention", q)
    b, hq, nq, dh = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    _heads("flash_attention", hq, hkv, dh)
    check(q, "q", q.dtype)
    check(k, "k", q.dtype, (b, hkv, nk, dh))
    check(v, "v", q.dtype, (b, hkv, nk, dh))
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window {window} must be positive")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    build.call("flash_attention", "rt_flash_attention", ptr(q), ptr(k),
               ptr(v), ptr(out), b, hq, hkv, nq, nk, dh,
               dh ** -0.5 if scale is None else scale, int(causal),
               window or 0, q_offset, code, _stream())
    return out


def decode_splits(batch: int, kv_heads: int, slots: int) -> int:
    """The key splits ``csrc/decode_attention.cu`` plans for ``batch``
    sequences of ``kv_heads`` KV heads over ``slots`` cache slots (about
    one block per SM, at most one per 32-key tile), which size the
    float32 workspace of the split partials."""
    splits = ctypes.c_int(1)
    build.call("decode_attention", "rt_decode_attention_splits", batch,
               kv_heads, slots, 0, ctypes.byref(splits))
    return splits.value


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, Dh); caches (B, Hkv, S, Dh); lengths (B,) int32 on the
    card -> (B, Hq, Dh) in q's dtype.  Slot j of sequence b is valid where
    j < lengths[b]; the kernel reads the lengths itself."""
    code = dtype_code("decode_attention", q)
    b, hq, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    _heads("decode_attention", hq, hkv, dh)
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {hq // hkv} query heads per KV "
                         f"head; the kernel takes at most {MAX_GROUP}")
    check(q, "q", q.dtype)
    check(k_cache, "k_cache", q.dtype, (b, hkv, s, dh))
    check(v_cache, "v_cache", q.dtype, (b, hkv, s, dh))
    check(lengths, "lengths", torch.int32, (b,))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits = decode_splits(b, hkv, s)
    ws = None if splits == 1 else torch.empty(
        b * hq * splits * (dh + 2), device=q.device, dtype=torch.float32)
    build.call("decode_attention", "rt_decode_attention", ptr(q),
               ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(out), ptr(ws),
               b, hq, hkv, s, dh, dh ** -0.5 if scale is None else scale,
               splits, code, _stream())
    return out
