"""TNT-S (Han et al. 2021, "Transformer in Transformer"), counterpart of
`repro/models/tnt.py`.

Every TNT layer runs an inner transformer over the pixel sub-patches of
each patch before the outer (patch-level) block.  The module owns the
model description (config, params, spec); `forward` compiles the config
into the control program's dual-stream schedule, per layer

  inner_msa -> inner_mlp -> fold -> msa -> mlp

(fused: ``inner_layer -> fold -> layer``), and replays it.  The inner
blocks are ordinary MSA/MLP phases whose batch axis carries images x
patches, so the same kernels serve both streams; the ``fold`` projects
each patch's flattened pixel tokens (LN, then linear, m*c -> D) back into
the outer stream as a residual.  Weights use the per-head ``wq/wk/wv
(H, D, Dh)`` layout of `models/vit.py` for both blocks of a layer (nested
as its ``inner`` and ``outer`` subtrees), so `core.quant` covers TNT with
no new machinery.  As for ViT and Swin here, the blocks are QKV-bias-free
and classification is by mean pooling (no class token).  A ``head_mask``
prunes the outer stream's heads; the inner stream stays dense.

`reference_forward` is a direct dense implementation (no kernels, no
schedule), the numerical oracle of the scheduled path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import schedule as sched_lib
from repro_torch.core.perfmodel import StageSpec, VisionModelSpec
from repro_torch.core.quant import prune_block_heads, quantize_vision_params
from repro_torch.kernels.ref import gelu, layer_norm_ref
from repro_torch.models.config import normalize_head_mask
from repro_torch.models.layers import cast_params, dense_init, to_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TNTConfig:
    name: str = "tnt_s_224"
    image: int = 224
    patch: int = 16                # outer patch side (pixels)
    inner_patch: int = 4           # pixel sub-patch side within a patch
    dim: int = 384                 # outer (patch) embedding width D
    inner_dim: int = 24            # inner (pixel) embedding width c
    heads: int = 6                 # outer MSA heads
    inner_heads: int = 4           # inner MSA heads
    layers: int = 12
    mlp_ratio: float = 4.0
    inner_mlp_ratio: float = 4.0
    n_classes: int = 1000
    dtype: str = "float32"         # every weight's dtype ("bfloat16": the
                                   # kernels' bf16 modes)
    fused: bool = True             # fuse (inner_)msa+mlp pairs into layers
    fuse_group: int = 1            # >1: group runs of fused layers (none
                                   # form: a fold sits between every two)
    # Per-layer outer head-pruning mask (layers x heads 0/1 tuples; None =
    # dense).  The inner heads stay dense.
    head_mask: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        object.__setattr__(
            self, "head_mask",
            normalize_head_mask(self.head_mask, layers=self.layers,
                                heads=self.heads))

    @property
    def tokens(self) -> int:
        """Outer (patch) tokens N."""
        return (self.image // self.patch) ** 2

    @property
    def inner_tokens(self) -> int:
        """Pixel tokens m per patch (the inner sequence length)."""
        return (self.patch // self.inner_patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def inner_head_dim(self) -> int:
        return self.inner_dim // self.inner_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def inner_mlp_hidden(self) -> int:
        return int(self.inner_dim * self.inner_mlp_ratio)

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * 3

    @property
    def inner_patch_dim(self) -> int:
        return self.inner_patch * self.inner_patch * 3

    @property
    def fold_dim(self) -> int:
        """Flattened inner stream of a patch, m * c (the fold's depth)."""
        return self.inner_tokens * self.inner_dim


def tnt_s(image: int = 224, **kw) -> TNTConfig:
    """The paper's TNT-S: 16 px patches of 16 4x4-pixel sub-patches, inner
    c 24 / 4 heads, outer D 384 / 6 heads, 12 layers."""
    return TNTConfig(name=f"tnt_s_{image}", image=image, **kw)


def tnt_edge(image: int = 32, **kw) -> TNTConfig:
    """CPU-sized TNT with the dual-stream geometry: a 4x4 patch grid, each
    8 px patch split into 4 sub-patches, 2 layers."""
    kw.setdefault("n_classes", 10)
    return TNTConfig(name=f"tnt_edge_{image}", image=image, patch=8,
                     inner_patch=4, dim=96, inner_dim=16, heads=4,
                     inner_heads=2, layers=2, **kw)


def _block(gen: torch.Generator, dim: int, n_heads: int,
           hidden: int) -> Params:
    """One transformer block in the schedule's per-head layout."""
    def per_head():
        return torch.stack([dense_init(gen, dim, dim // n_heads)
                            for _ in range(n_heads)])

    return {
        "ln1_w": torch.ones(dim), "ln1_b": torch.zeros(dim),
        "wq": per_head(), "wk": per_head(), "wv": per_head(),  # (H, D, Dh)
        "w_msa": dense_init(gen, dim, dim),
        "ln2_w": torch.ones(dim), "ln2_b": torch.zeros(dim),
        "w_up": dense_init(gen, dim, hidden), "b_up": torch.zeros(hidden),
        "w_down": dense_init(gen, hidden, dim), "b_down": torch.zeros(dim),
    }


def init_params(cfg: TNTConfig, seed: int = 0, device="cpu") -> Params:
    """Random params from ``seed`` (a `torch.Generator` on the CPU, so
    every device gets the same weights), drawn in float32, cast to
    ``cfg.dtype`` and placed on ``device``.  Same layout and distributions
    as the JAX init; the numbers differ (tests carry JAX's weights across
    with `convert.params_from_numpy`).  A ``head_mask`` prunes each
    layer's outer block after the dense draw, as in
    `models.vit.init_params`."""
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {
        # inner frontend: sub-patch pixels -> pixel embeddings + pixel pos
        "pixel_embed": dense_init(gen, cfg.inner_patch_dim, cfg.inner_dim),
        "inner_pos_embed": torch.randn((cfg.inner_tokens, cfg.inner_dim),
                                       generator=gen) * 0.02,
        # outer frontend: LN(flattened pixel tokens) -> patch embeddings
        "pe_ln_w": torch.ones(cfg.fold_dim),
        "pe_ln_b": torch.zeros(cfg.fold_dim),
        "patch_embed": dense_init(gen, cfg.fold_dim, cfg.dim),
        "pos_embed": torch.randn((cfg.tokens, cfg.dim), generator=gen) * 0.02,
    }
    layers = []
    for _ in range(cfg.layers):
        layers.append({
            "inner": _block(gen, cfg.inner_dim, cfg.inner_heads,
                            cfg.inner_mlp_hidden),
            "fold_ln_w": torch.ones(cfg.fold_dim),
            "fold_ln_b": torch.zeros(cfg.fold_dim),
            "fold_w": dense_init(gen, cfg.fold_dim, cfg.dim),
            "fold_b": torch.zeros(cfg.dim),
            "outer": _block(gen, cfg.dim, cfg.heads, cfg.mlp_hidden),
        })
    params["layers"] = layers
    params["ln_f_w"] = torch.ones(cfg.dim)
    params["ln_f_b"] = torch.zeros(cfg.dim)
    params["head"] = dense_init(gen, cfg.dim, cfg.n_classes)
    params = cast_params(params, getattr(torch, cfg.dtype))
    if cfg.head_mask:
        for lp, row in zip(params["layers"], cfg.head_mask):
            lp["outer"] = prune_block_heads(lp["outer"], row)
    return to_device(params, device)


def to_spec(cfg: TNTConfig) -> VisionModelSpec:
    """The stage description the schedule compiler consumes; the
    ``inner_*`` fields carry the pixel-level transformer."""
    stage = StageSpec(layers=cfg.layers, dim=cfg.dim, heads=cfg.heads,
                      mlp_ratio=cfg.mlp_ratio, tokens=cfg.tokens,
                      inner_tokens=cfg.inner_tokens, inner_dim=cfg.inner_dim,
                      inner_heads=cfg.inner_heads,
                      inner_mlp_ratio=cfg.inner_mlp_ratio,
                      head_mask=cfg.head_mask)
    return VisionModelSpec(name=cfg.name, image=(cfg.image, cfg.image, 3),
                           patch=cfg.patch, stages=(stage,),
                           embed_dim=cfg.dim)


@functools.lru_cache(maxsize=None)
def schedule(cfg: TNTConfig) -> sched_lib.Schedule:
    """The dual-stream phase schedule `forward` replays, fused unless
    ``cfg.fused`` is False (grouping at ``cfg.fuse_group`` forms no group:
    a fold sits between every two layers of a stream)."""
    s = sched_lib.compile_schedule(to_spec(cfg), n_classes=cfg.n_classes,
                                   hierarchical=False)
    return sched_lib.fuse_schedule(s, group_size=cfg.fuse_group) \
        if cfg.fused else s


def forward(params: Params, patches: torch.Tensor, cfg: TNTConfig,
            observer=None) -> torch.Tensor:
    """patches (B, (image/patch)^2, P*P*3) -> logits (B, n_classes).
    `QTensor` params plus a `Calibrator` observer run the int8 PTQ path."""
    return sched_lib.run_schedule(schedule(cfg), params, patches,
                                  observer=observer)


def quantize_tnt(params: Params) -> Params:
    """int8 PTQ: per-(head, channel) QKV for the inner and outer blocks,
    per-channel pixel embed, patch embed, fold, MLP and head matmuls."""
    return quantize_vision_params(params)


# ---------------------------------------------------------------------------
# Dense reference path (numerical oracle of the scheduled execution)
# ---------------------------------------------------------------------------


def _msa_ref(bp: Params, x: torch.Tensor) -> torch.Tensor:
    """Global per-head MSA on (B', N, C): direct einsums, no kernels."""
    dh = bp["wq"].shape[2]
    q, k, v = (torch.einsum("bnc,hcd->bhnd", x, bp[key])
               for key in ("wq", "wk", "wv"))
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) * (dh ** -0.5)
    o = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(s, dim=-1), v)
    b, n = x.shape[:2]
    return o.permute(0, 2, 1, 3).reshape(b, n, -1) @ bp["w_msa"]


def _block_ref(bp: Params, x: torch.Tensor) -> torch.Tensor:
    """Pre-LN transformer block (MSA and MLP residuals), dense."""
    x = x + _msa_ref(bp, layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"]))
    h = layer_norm_ref(x, bp["ln2_w"], bp["ln2_b"])
    return x + gelu(h @ bp["w_up"] + bp["b_up"]) @ bp["w_down"] \
        + bp["b_down"]


def reference_forward(params: Params, patches: torch.Tensor,
                      cfg: TNTConfig) -> torch.Tensor:
    """Float-only oracle: the schedule's math, written directly."""
    b, n, _ = patches.shape
    sub = sched_lib.pixel_partition(patches, cfg.inner_tokens)
    y = sub @ params["pixel_embed"] + params["inner_pos_embed"][None]
    flat = layer_norm_ref(y.reshape(b, n, -1), params["pe_ln_w"],
                          params["pe_ln_b"])
    x = flat @ params["patch_embed"] + params["pos_embed"][None]
    for lp in params["layers"]:
        y = _block_ref(lp["inner"], y)
        flat = layer_norm_ref(y.reshape(b, n, -1), lp["fold_ln_w"],
                              lp["fold_ln_b"])
        x = x + flat @ lp["fold_w"] + lp["fold_b"]
        x = _block_ref(lp["outer"], x)
    x = layer_norm_ref(x, params["ln_f_w"], params["ln_f_b"])
    return x.mean(dim=1) @ params["head"]
