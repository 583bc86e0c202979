"""Swin-T (Liu et al. 2021): windowed and shifted MSA plus patch merging,
counterpart of `repro/models/swin.py`.

The module owns the model description (config, params, spec).  `forward`
compiles the config into a hierarchical `core.schedule.Schedule` and
replays it through the same kernels as ViT/DeiT: windows folded into the
batch axis, the relative-position bias and the shifted-window mask passed
to the attention, the MLP through the fused MLP (unfused) or the fused
layer, and patch merging as a schedule phase.  Weights use the per-head
``wq/wk/wv (H, D, Dh)`` layout of `models/vit.py`, so the int8 PTQ path
covers Swin with no new machinery.

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
class SwinConfig:
    name: str = "swin_t_224"
    image: int = 224
    patch: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    n_classes: int = 1000
    dtype: str = "float32"         # every weight's dtype ("bfloat16": the
                                   # kernels' bf16 modes)
    fused: bool = True             # fuse msa+mlp pairs into layer phases
    fuse_group: int = 1            # >1: group runs of fused layers into
                                   # layer_group phases
    # Per-stage head-pruning masks ``head_mask[stage][layer][head]``
    # (None = dense).
    head_mask: Optional[Tuple[Tuple[Tuple[int, ...], ...], ...]] = None

    def __post_init__(self):
        if self.head_mask is None:
            return
        if len(self.head_mask) != len(self.depths):
            raise ValueError(
                f"head mask has {len(self.head_mask)} stages, config "
                f"has {len(self.depths)}")
        object.__setattr__(self, "head_mask", tuple(
            normalize_head_mask(m, layers=d, heads=h)
            for m, d, h in zip(self.head_mask, self.depths, self.heads)))

    def stage_mask(self, s_i: int):
        return self.head_mask[s_i] if self.head_mask else None

    @property
    def patch_dim(self) -> int:
        return self.patch * self.patch * 3

    def stage_dim(self, s_i: int) -> int:
        return self.embed_dim * (2 ** s_i)

    def stage_side(self, s_i: int) -> int:
        return (self.image // self.patch) // (2 ** s_i)


def swin_t(image: int = 224, **kw) -> SwinConfig:
    """The paper's Swin-T: patch 4, window 7, depths (2, 2, 6, 2)."""
    return SwinConfig(name=f"swin_t_{image}", image=image, **kw)


def swin_edge(image: int = 56, **kw) -> SwinConfig:
    """CPU-sized two-stage Swin with real window geometry: stage 0 has a
    14x14 grid of 4 shifted 7x7 windows, patch merging, then a 7x7
    single-window stage."""
    kw.setdefault("n_classes", 10)
    return SwinConfig(name=f"swin_edge_{image}", image=image, patch=4,
                      embed_dim=48, depths=(2, 2), heads=(3, 6), window=7,
                      **kw)


def init_params(cfg: SwinConfig, seed: int = 0, device="cpu") -> Params:
    """Random params from ``seed`` (a `torch.Generator` on the CPU, so
    every device gets the same weights), drawn in float32, cast to
    ``cfg.dtype`` (every leaf: the relative-position tables, the merge and
    embed LayerNorms too) and placed on ``device``.  Same layout and
    distributions as the JAX init; the numbers differ (tests carry JAX's
    weights across with `convert.params_from_numpy`).  A ``head_mask``
    prunes each stage's blocks after the dense draw, as in
    `models.vit.init_params`."""
    gen = torch.Generator().manual_seed(int(seed))

    def per_head(dim, n_heads):
        return torch.stack([dense_init(gen, dim, dim // n_heads)
                            for _ in range(n_heads)])

    params: Params = {
        "patch_embed": dense_init(gen, cfg.patch_dim, cfg.embed_dim),
        "pe_ln_w": torch.ones(cfg.embed_dim),
        "pe_ln_b": torch.zeros(cfg.embed_dim),
    }
    stages = []
    dim = cfg.embed_dim
    for s_i, (depth, n_heads) in enumerate(zip(cfg.depths, cfg.heads)):
        hid = int(dim * cfg.mlp_ratio)
        blocks = []
        for _ in range(depth):
            blocks.append({
                "ln1_w": torch.ones(dim), "ln1_b": torch.zeros(dim),
                "wq": per_head(dim, n_heads), "wk": per_head(dim, n_heads),
                "wv": per_head(dim, n_heads),             # (H, D, Dh)
                "w_msa": dense_init(gen, dim, dim),
                "rel_bias": torch.randn(((2 * cfg.window - 1) ** 2, n_heads),
                                        generator=gen) * 0.02,
                "ln2_w": torch.ones(dim), "ln2_b": torch.zeros(dim),
                "w_up": dense_init(gen, dim, hid), "b_up": torch.zeros(hid),
                "w_down": dense_init(gen, hid, dim),
                "b_down": torch.zeros(dim),
            })
        stage: Params = {"blocks": blocks}
        if s_i < len(cfg.depths) - 1:
            stage["merge_ln_w"] = torch.ones(4 * dim)
            stage["merge_ln_b"] = torch.zeros(4 * dim)
            stage["merge_w"] = dense_init(gen, 4 * dim, 2 * dim)
            dim *= 2
        stages.append(stage)
    params["stages"] = stages
    params["ln_f_w"] = torch.ones(dim)
    params["ln_f_b"] = torch.zeros(dim)
    params["head"] = dense_init(gen, dim, cfg.n_classes)
    params = cast_params(params, getattr(torch, cfg.dtype))
    for s_i, stage in enumerate(params["stages"]):
        mask = cfg.stage_mask(s_i)
        if mask:
            stage["blocks"] = [prune_block_heads(bp, row)
                               for bp, row in zip(stage["blocks"], mask)]
    return to_device(params, device)


def to_spec(cfg: SwinConfig) -> VisionModelSpec:
    """The stage description the schedule compiler consumes."""
    stages = []
    for s_i, (depth, n_heads) in enumerate(zip(cfg.depths, cfg.heads)):
        side = cfg.stage_side(s_i)
        stages.append(StageSpec(
            layers=depth, dim=cfg.stage_dim(s_i), heads=n_heads,
            mlp_ratio=cfg.mlp_ratio, tokens=cfg.window * cfg.window,
            n_windows=(side // cfg.window) ** 2,
            patch_merging=(s_i < len(cfg.depths) - 1),
            head_mask=cfg.stage_mask(s_i)))
    return VisionModelSpec(name=cfg.name, image=(cfg.image, cfg.image, 3),
                           patch=cfg.patch, stages=tuple(stages),
                           embed_dim=cfg.embed_dim)


@functools.lru_cache(maxsize=None)
def schedule(cfg: SwinConfig) -> sched_lib.Schedule:
    """The hierarchical phase schedule `forward` replays, fused unless
    ``cfg.fused`` is False, grouped at ``cfg.fuse_group``."""
    s = sched_lib.compile_schedule(to_spec(cfg), n_classes=cfg.n_classes,
                                   hierarchical=True)
    return sched_lib.fuse_schedule(s, group_size=cfg.fuse_group) \
        if cfg.fused else s


def forward(params: Params, patches: torch.Tensor, cfg: SwinConfig,
            observer=None) -> torch.Tensor:
    """patches (B, (image/patch)^2, P*P*3) -> logits (B, n_classes).
    `QTensor` params plus a `Calibrator` observer run the int8 PTQ path."""
    return sched_lib.run_schedule(schedule(cfg), params, patches,
                                  observer=observer)


def quantize_swin(params: Params) -> Params:
    """int8 PTQ (per-(head, channel) wq/wk/wv, per-channel matmuls)."""
    return quantize_vision_params(params)


# ---------------------------------------------------------------------------
# Dense reference path (numerical oracle of the scheduled execution)
# ---------------------------------------------------------------------------


def _wmsa_ref(bp: Params, x: torch.Tensor, win: int, shift: int,
              rel_idx: torch.Tensor) -> torch.Tensor:
    """Windowed MSA on (B, H, W, C) tokens: direct einsums, no kernels."""
    _, h, w, _ = x.shape
    n_heads, _, dh = bp["wq"].shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    xw = sched_lib.window_partition(x, win)             # (B*nW, n, C)
    n = win * win
    q, k, v = (torch.einsum("wnc,hcd->whnd", xw, bp[key])
               for key in ("wq", "wk", "wv"))
    s = torch.einsum("whnd,whmd->whnm", q, k) * (dh ** -0.5)
    s = s + bp["rel_bias"][rel_idx].permute(2, 0, 1)[None]
    mask = torch.from_numpy(
        sched_lib.shifted_window_mask(h, w, win, shift)).to(x.device)
    s = s + mask.repeat(s.shape[0] // mask.shape[0], 1, 1)[:, None]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("whnm,whmd->whnd", p, v)
    o = o.permute(0, 2, 1, 3).reshape(-1, n, n_heads * dh) @ bp["w_msa"]
    o = sched_lib.window_reverse(o, win, h, w)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o


def reference_forward(params: Params, patches: torch.Tensor,
                      cfg: SwinConfig) -> torch.Tensor:
    """Float-only oracle: the schedule's math, written directly."""
    b = patches.shape[0]
    side = cfg.image // cfg.patch
    x = patches @ params["patch_embed"]
    x = layer_norm_ref(x, params["pe_ln_w"], params["pe_ln_b"])
    x = x.reshape(b, side, side, cfg.embed_dim)
    rel_idx = torch.from_numpy(
        sched_lib.rel_pos_index(cfg.window).astype("int64")).to(x.device)
    for stage in params["stages"]:
        for b_i, bp in enumerate(stage["blocks"]):
            h, w, c = x.shape[1:]
            n_windows = (h // cfg.window) * (w // cfg.window)
            shift = (cfg.window // 2 if b_i % 2 == 1 and n_windows > 1
                     else 0)
            ln = layer_norm_ref(x, bp["ln1_w"], bp["ln1_b"])
            x = x + _wmsa_ref(bp, ln, cfg.window, shift, rel_idx)
            ln = layer_norm_ref(x, bp["ln2_w"], bp["ln2_b"])
            hid = gelu(ln.reshape(b, h * w, c) @ bp["w_up"] + bp["b_up"])
            y = hid @ bp["w_down"] + bp["b_down"]
            x = x + y.reshape(b, h, w, c)
        if "merge_w" in stage:
            h, w, c = x.shape[1:]
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            x = layer_norm_ref(x, stage["merge_ln_w"], stage["merge_ln_b"])
            x = x @ stage["merge_w"]
    x = layer_norm_ref(x, params["ln_f_w"], params["ln_f_b"])
    return x.mean(dim=(1, 2)) @ params["head"]
