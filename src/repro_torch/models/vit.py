"""Columnar vision transformers (ViT / DeiT), counterpart of
`repro/models/vit.py`.

The module owns the model description (config, params, spec); execution
belongs to the control program: `schedule(cfg)` compiles the config into a
`core.schedule.Schedule` (fused unless ``cfg.fused`` is False, grouped
into ``layer_group`` phases when ``cfg.fuse_group`` > 1) and `forward`
replays it.  A ``head_mask`` prunes heads at init (`init_params`).
Images are NHWC at the public functions, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import schedule as sched_lib
from repro_torch.core.perfmodel import StageSpec, VisionModelSpec
from repro_torch.core.quant import prune_block_heads, quantize_vision_params
from repro_torch.models.config import normalize_head_mask
from repro_torch.models.layers import cast_params, dense_init, to_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    image: int = 256
    patch: int = 16
    dim: int = 768
    heads: int = 12
    layers: int = 12
    mlp_ratio: float = 4.0
    n_classes: int = 1000
    dtype: str = "float32"         # every weight's dtype ("bfloat16": the
                                   # kernels' bf16 modes)
    fused: bool = True             # fuse msa+mlp pairs into layer phases
    fuse_group: int = 1            # >1: group runs of fused layers into
                                   # layer_group phases
    # Per-layer head-pruning mask (layers x heads 0/1 tuples; None = dense).
    # ``heads``/``head_dim`` stay architectural: the mask slices the
    # per-head stacks at init and the schedule's head counts follow.
    head_mask: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self):
        object.__setattr__(
            self, "head_mask",
            normalize_head_mask(self.head_mask, layers=self.layers,
                                heads=self.heads))

    @property
    def tokens(self) -> int:
        return (self.image // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * 3


def vit_b16(image: int = 256, **kw) -> ViTConfig:
    return ViTConfig(name=f"vit_b16_{image}", image=image, **kw)


def deit_s(**kw) -> ViTConfig:
    return ViTConfig(name="deit_s_224", image=224, dim=384, heads=6, **kw)


def deit_t(**kw) -> ViTConfig:
    return ViTConfig(name="deit_t_224", image=224, dim=192, heads=3, **kw)


def init_params(cfg: ViTConfig, seed: int = 0,
                device="cpu") -> Params:
    """Random params from ``seed`` (a `torch.Generator` on the CPU, so
    every device gets the same weights), drawn in float32, cast to
    ``cfg.dtype`` and placed on ``device``.  Same layout and distributions
    as the JAX init; the numbers differ (tests carry JAX's weights across
    with `convert.params_from_numpy`).  A ``head_mask`` draws the dense
    weights first (the same stream as the unmasked config) and then prunes
    each layer, in ``cfg.dtype`` as the JAX init does, so surviving heads
    equal the dense model's."""
    gen = torch.Generator().manual_seed(int(seed))
    d, dh, m = cfg.dim, cfg.head_dim, cfg.mlp_hidden

    def heads():
        return torch.stack([dense_init(gen, d, dh) for _ in range(cfg.heads)])

    params: Params = {
        "patch_embed": dense_init(gen, cfg.patch_dim, d),
        "pos_embed": torch.randn((cfg.tokens, d), generator=gen) * 0.02,
    }
    layers = []
    for _ in range(cfg.layers):
        layers.append({
            "ln1_w": torch.ones(d), "ln1_b": torch.zeros(d),
            "wq": heads(), "wk": heads(), "wv": heads(),   # (H, D, Dh)
            "w_msa": dense_init(gen, d, d),
            "ln2_w": torch.ones(d), "ln2_b": torch.zeros(d),
            "w_up": dense_init(gen, d, m), "b_up": torch.zeros(m),
            "w_down": dense_init(gen, m, d), "b_down": torch.zeros(d),
        })
    params["layers"] = layers
    params["ln_f_w"] = torch.ones(d)
    params["ln_f_b"] = torch.zeros(d)
    params["head"] = dense_init(gen, d, cfg.n_classes)
    params = cast_params(params, getattr(torch, cfg.dtype))
    if cfg.head_mask:
        params["layers"] = [prune_block_heads(lp, row)
                            for lp, row in zip(params["layers"],
                                               cfg.head_mask)]
    return to_device(params, device)


def to_spec(cfg: ViTConfig) -> VisionModelSpec:
    """The stage description the schedule compiler consumes."""
    stage = StageSpec(layers=cfg.layers, dim=cfg.dim, heads=cfg.heads,
                      mlp_ratio=cfg.mlp_ratio, tokens=cfg.tokens,
                      head_mask=cfg.head_mask)
    return VisionModelSpec(name=cfg.name, image=(cfg.image, cfg.image, 3),
                           patch=cfg.patch, stages=(stage,),
                           embed_dim=cfg.dim)


@functools.lru_cache(maxsize=None)
def schedule(cfg: ViTConfig) -> sched_lib.Schedule:
    """The phase schedule `forward` replays: embed, one fused ``layer``
    per encoder block (or its msa and mlp phases when ``cfg.fused`` is
    False; runs of up to ``cfg.fuse_group`` layers as ``layer_group``
    phases), head."""
    s = sched_lib.compile_schedule(to_spec(cfg), n_classes=cfg.n_classes,
                                   hierarchical=False)
    return sched_lib.fuse_schedule(s, group_size=cfg.fuse_group) \
        if cfg.fused else s


def forward(params: Params, patches: torch.Tensor, cfg: ViTConfig,
            observer=None) -> torch.Tensor:
    """patches (B, N, P*P*3) -> logits (B, n_classes).  `QTensor` params
    plus a `Calibrator` observer run the int8 PTQ path."""
    return sched_lib.run_schedule(schedule(cfg), params, patches,
                                  observer=observer)


def quantize_vit(params: Params) -> Params:
    """Per-channel int8 PTQ of all ViT weights (biases and norms stay
    float)."""
    return quantize_vision_params(params)


def extract_patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, P*P*3) patch pixel vectors."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)
