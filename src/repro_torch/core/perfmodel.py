"""Model stage descriptions read by the schedule compiler (a copy of
`StageSpec` and `VisionModelSpec` from `repro/core/perfmodel.py`; the
analytic ViTA cycle model itself is not part of the port)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a (possibly hierarchical) vision transformer.

    The ``inner_*`` fields describe a TNT-style inner (pixel-level)
    transformer that runs before each outer block: ``inner_tokens`` pixel
    tokens of ``inner_dim`` channels per outer token, attended by
    ``inner_heads`` heads, folded back into the outer stream by a linear
    projection.  ``inner_tokens == 0`` (the default) means no inner blocks
    — plain ViT/DeiT/Swin stages are unaffected.
    """

    layers: int
    dim: int                      # latent dim D for this stage
    heads: int
    mlp_ratio: float = 4.0
    tokens: int = 0               # sequence length N seen by MSA (per window)
    n_windows: int = 1            # windows per image (Swin); 1 = global MSA
    patch_merging: bool = False   # patch-merging layer after this stage
    inner_tokens: int = 0         # TNT pixel tokens per outer token (0 = off)
    inner_dim: int = 0            # TNT pixel-embedding channels c
    inner_heads: int = 0          # TNT inner-MSA heads
    inner_mlp_ratio: float = 4.0  # TNT inner-MLP expansion
    # Per-layer head-pruning mask: ``head_mask[layer][head]`` is 1 to keep
    # the head, 0 to drop it (canonical nested-tuple form of
    # `models.config.normalize_head_mask`).  ``heads`` stays the
    # ARCHITECTURAL count (head_dim never changes under pruning); the
    # surviving count per layer is `layer_heads`.  None = dense.
    head_mask: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def layer_heads(self, layer: int) -> int:
        """Surviving MSA heads of one layer (== ``heads`` when dense)."""
        if not self.head_mask:
            return self.heads
        return int(sum(self.head_mask[layer]))

    @property
    def head_counts(self) -> Tuple[int, ...]:
        """Surviving head count per layer, in layer order."""
        return tuple(self.layer_heads(i) for i in range(self.layers))

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def inner_head_dim(self) -> int:
        return self.inner_dim // self.inner_heads if self.inner_heads else 0

    @property
    def inner_mlp_hidden(self) -> int:
        return int(self.inner_dim * self.inner_mlp_ratio)


@dataclasses.dataclass(frozen=True)
class VisionModelSpec:
    name: str
    image: Tuple[int, int, int]
    patch: int
    stages: Tuple[StageSpec, ...]
    embed_dim: int                # dim right after patch embedding

    @property
    def patch_tokens(self) -> int:
        h, w, _ = self.image
        return (h // self.patch) * (w // self.patch)

