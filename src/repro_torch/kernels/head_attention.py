"""LM attention on Hopper (counterpart of
`repro/kernels/head_attention.py`): `flash_attention` for prefill and
`decode_attention` for one query per sequence over a KV cache.

`flash_attention` launches ``csrc/flash_attention.cu`` over the
tensor-core tile of ``csrc/head_attention.cuh`` (S and P.V on `mma.sync`:
bf16, or split TF32 on fp32), as `flash_plan` lays it out; `decode_attention`
launches ``csrc/decode_attention.cu``, split over the cache
(flash-decoding: `decode_splits` key ranges per KV head, combined in
split order by a second kernel) with the K/V tiles streamed by
asynchronous copies.  Their source notes say what bounds them.
float32 or bfloat16 in and out, float32 sums; head_dim up to 256.  These
functions take CUDA tensors only; the plain versions are
`ref.attention_ref` and `ref.decode_attention_ref`, chosen by `ops`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .build import check, dtype_code, ptr, stream

MAX_HEAD_DIM = 256
MAX_GROUP = 16        # query rows of one decode tile (Hq / Hkv)
# The flash tile's query rows a row group, and the tiles it is built for:
# (element size, head-dim class) -> ((keys a tile, row groups, warps a
# group) where Nq <= 16, the same above), the fastest that fit at
# RecurrentGemma-2B's (Dh 256) and stablelm-3b's (Dh 80) prefills
# (csrc/flash_attention.cu's note); each layout fits one block's
# `build.SMEM_LIMIT`.
FLASH_WARP_ROWS = 16
FLASH_TILES = {(2, 128): ((16, 1, 4), (64, 4, 1)),
               (2, 256): ((16, 1, 4), (64, 8, 1)),
               (4, 128): ((16, 1, 4), (32, 4, 1)),
               (4, 256): ((16, 1, 4), (16, 8, 2))}


def _heads(name: str, hq: int, hkv: int, dh: int) -> None:
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{name}: {hq} query heads do not group over {hkv} "
                         f"KV heads")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {dh} outside 1..{MAX_HEAD_DIM}")


class FlashPlan(NamedTuple):
    """One csrc/flash_attention.cu launch: ``grid`` = (query heads, query
    tiles, sequences) blocks of ``rows`` query rows (a warp per 16), each
    walking its keys (`walk`) in tiles of ``bk``; the kernel built for head
    dims up to ``dmax``, Dh padded with zeros to ``dp``, ``nw`` warps
    sharing each group of 16 rows; shared memory Q [rows][q_ld bytes], then
    two ring stages of ``stage`` bytes (K [bk][k_ld], V [bk][v_ld]), then
    where nw > 1 the partial scores the warps of a group exchange, ``smem``
    in all; rows copied by 16-byte cp.async where
    ``vec``, else by plain loads.  ``path`` names the products: "mma_bf16"
    (mma.sync m16n8k16) or "split_tf32" (mma.sync m16n8k8, three passes)."""
    path: str
    dmax: int
    rows: int
    bk: int
    nw: int
    dp: int
    q_ld: int
    k_ld: int
    v_ld: int
    stage: int
    smem: int
    vec: int
    grid: tuple
    nq: int
    nk: int
    causal: bool
    window: int
    q_offset: int

    def walk(self, tile: int):
        """(k_begin, k_end): the keys query tile ``tile`` walks, as the
        kernel's `fa_walk`: from the first key its first row sees, rounded
        down to a whole tile, to the last its last row sees; empty (k_end
        <= k_begin) where its rows see none."""
        q0 = tile * self.rows
        rows = min(self.rows, self.nq - q0)
        p0 = self.q_offset + q0
        first = max(0, p0 - self.window + 1) if self.window > 0 else 0
        k_end = min(self.nk, p0 + rows) if self.causal else self.nk
        k_begin = first // self.bk * self.bk
        return k_begin, (k_end if first < k_end else k_begin)

    def keys_walked(self) -> int:
        """Keys loaded by one (head, sequence): whole tiles of every query
        tile's walk."""
        total = 0
        for tile in range(self.grid[1]):
            kb, ke = self.walk(tile)
            total += max(0, -(-(ke - kb) // self.bk)) * self.bk
        return total

    def launch_ints(self):
        """The 11 ints the C entry takes (csrc/head_attention.cuh's
        FlashLayout)."""
        return (self.dmax, self.rows, self.bk, self.nw, self.dp, self.q_ld,
                self.k_ld, self.v_ld, self.stage, self.smem, self.vec)


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, hq: int, nq: int, nk: int, dh: int, elem_size: int,
               causal: bool = True, window: Optional[int] = None,
               q_offset: int = 0, aligned: bool = True,
               few_rows: Optional[bool] = None) -> FlashPlan:
    """The flash kernel's plan for ``b`` sequences of ``hq`` query heads,
    ``nq`` queries at positions ``q_offset`` .. against ``nk`` keys of head
    dim ``dh``, elements of ``elem_size`` bytes (2: bf16, 4: fp32), q, k and
    v 16-byte ``aligned``.  The smallest head-dim class (128 or 256) that
    holds Dh padded to 16, and its `FLASH_TILES` entry: 16 query rows
    shared by four warps where nq <= 16, else 64 or 128 (``few_rows``
    forces either: what
    chip_smoke.py measures the choice by); 16-byte copies where a row is
    whole chunks and the tensors are aligned."""
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {dh} outside "
                         f"1..{MAX_HEAD_DIM}")
    dp = -(-dh // 16) * 16
    dmax = 128 if dp <= 128 else 256
    if few_rows is None:
        few_rows = nq <= FLASH_WARP_ROWS
    bk, groups, nw = FLASH_TILES[(elem_size, dmax)][not few_rows]
    rows = FLASH_WARP_ROWS * groups
    if elem_size == 2:
        q_ld = k_ld = v_ld = 2 * dp + 16     # an odd count of 16-byte chunks
    else:
        q_ld = k_ld = (dp + 8) * 4
        v_ld = (dp + 4) * 4
    stage = bk * (k_ld + v_ld)
    # the warps of a shared group exchange partial scores: bk x 16 fp32 each
    smem = rows * q_ld + 2 * stage + (groups * nw * bk * 16 * 4 if nw > 1
                                      else 0)
    vec = int(aligned and (dh * elem_size) % 16 == 0)
    return FlashPlan("mma_bf16" if elem_size == 2 else "split_tf32", dmax,
                     rows, bk, nw, dp, q_ld, k_ld, v_ld, stage, smem, vec,
                     (hq, -(-nq // rows), b), nq, nk, bool(causal),
                     window or 0, q_offset)


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             q_offset: int = 0) -> FlashPlan:
    """`flash_plan` of a `flash_attention` call on these tensors."""
    b, hq, nq, dh = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return flash_plan(b, hq, nq, k.shape[2], dh, q.element_size(), causal,
                      window, q_offset, aligned)


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
    plan = plan_for(q, k, v, causal=causal, window=window,
                    q_offset=q_offset).launch_ints()
    build.call("flash_attention", "rt_flash_attention", ptr(q), ptr(k),
               ptr(v), ptr(out), b, hq, hkv, nq, nk, dh,
               dh ** -0.5 if scale is None else scale, int(causal),
               window or 0, q_offset, code,
               build.ints(plan), stream())
    return out


def decode_splits(batch: int, kv_heads: int, slots: int) -> int:
    """The key splits ``csrc/decode_attention.cu`` plans for ``batch``
    sequences of ``kv_heads`` KV heads over ``slots`` cache slots (about
    one block per SM, at most one per 32-key tile), which size the
    float32 workspace of the split partials."""
    return build.query("decode_attention", "rt_decode_attention_splits",
                       batch, kv_heads, slots, 0)


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
               splits, code, stream())
    return out
