"""int8 gradient compression with error feedback (counterpart of
`repro/optim/compress.py`).

    e_t      <- residual from last step
    c_t      = Q(g_t + e_t)            # per-tensor symmetric int8
    e_{t+1}  = (g_t + e_t) - deQ(c_t)

The optimizer sees exactly what a receiver of the compressed all-reduce
would decode.  The scale is per tensor of the JAX package's tree, whose
per-layer tensors are stacked over the superblocks (`stack_key`).  The
codes round half to even (`torch.round`, as `jnp.round`), so they equal
the JAX package's code for code.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_lib

CompressionState = Any   # tree of float32 residuals


def ef_init(params: Any) -> CompressionState:
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)


def compress_int8(g: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``g`` and their scale, amax / 127 where
    ``amax`` defaults to max |g| (a stack's shared amax otherwise)."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def stack_key(path: tree_lib.Path, pattern_len: int) -> tree_lib.Path:
    """The JAX package's leaf that the port's leaf at ``path`` is a slice
    of: ``layers[i]`` is pattern position i % ``pattern_len`` of its
    superblock, and the JAX package stacks each position's leaves over
    the superblocks."""
    if "layers" not in path:
        return path
    k = path.index("layers") + 1
    return path[:k] + (path[k] % pattern_len,) + path[k + 1:]


@torch.no_grad()
def ef_compress_grads(grads: Any, residuals: CompressionState,
                      pattern_len: int = 1) -> Tuple[Any, CompressionState]:
    """(decoded grads as seen after the compressed all-reduce, in each
    gradient's dtype; new residuals).  The scale is per tensor of the
    JAX package's tree: a leaf under ``layers`` shares it with the same
    leaf of every layer at its pattern position (`stack_key`), so the
    codes equal the JAX package's."""
    corrected = tree_lib.tree_map(lambda g, e: g.float() + e, grads,
                                  residuals)
    amax = {}
    for path, c in tree_lib.leaves_with_path(corrected):
        key = stack_key(path, pattern_len)
        m = torch.max(torch.abs(c))
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)

    def one(path, g, c):
        q, s = compress_int8(c, amax[stack_key(path, pattern_len)])
        decoded = decompress_int8(q, s)
        return decoded.to(g.dtype), c - decoded

    return tree_lib.unzip(grads, tree_lib.map_with_path(one, grads,
                                                        corrected), 2)
