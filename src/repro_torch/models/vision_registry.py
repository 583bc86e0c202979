"""Registry of the vision models the port serves (counterpart of
`repro/models/vision_registry.py`): the ViT family (`vit_edge`, `deit_t`),
Swin-T (`swin_t`), TNT-S (`tnt_s`) and their head-pruned variants
(`vit_edge_p`, `deit_t_p`, `swin_t_p`, `tnt_s_p`) — the paper's whole
workload table.

Each entry has a ``reduced`` geometry (what the CPU tests run) and the
paper's ``full`` one (what runs on the card).  The family-generic helpers
(`forward_fn`, `init_params`, `make_schedule`, `quantize`) dispatch on the
config type, so the server stays model-agnostic; `make_spec` gives the
analytic model's description of a config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import schedule as sched_lib
from repro_torch.core.quant import quantize_vision_params
from repro_torch.models import swin, tnt, vit


@dataclasses.dataclass(frozen=True)
class VisionModel:
    name: str
    family: str                       # "vit" | "swin" | "tnt"
    description: str
    reduced: Callable[[], Any]        # -> ViTConfig | SwinConfig | TNTConfig
    full: Callable[[], Any]


_REGISTRY: Dict[str, VisionModel] = {
    m.name: m for m in (
        VisionModel(
            name="vit_edge", family="vit",
            description="edge-scale plain ViT; full = ViT-B/16 at 256 px",
            reduced=lambda: vit.ViTConfig(name="vit_edge_32", image=32,
                                          patch=8, dim=96, heads=4,
                                          layers=4, n_classes=10),
            full=lambda: vit.vit_b16(256)),
        VisionModel(
            name="deit_t", family="vit",
            description="DeiT-Tiny geometry (dim 192, 3 heads); reduced "
                        "depth 4",
            reduced=lambda: vit.ViTConfig(name="deit_t_64", image=64,
                                          patch=16, dim=192, heads=3,
                                          layers=4, n_classes=10),
            full=lambda: vit.deit_t()),
        VisionModel(
            name="swin_t", family="swin",
            description="Swin-T through the windowed control program; "
                        "reduced = 2-stage 56px variant with shifted 7x7 "
                        "windows + merging",
            reduced=lambda: swin.swin_edge(),
            full=lambda: swin.swin_t()),
        VisionModel(
            name="tnt_s", family="tnt",
            description="TNT-S inner/outer dual stream; pixel blocks "
                        "batch-folded onto the same kernels; reduced = "
                        "32px 2-layer",
            reduced=lambda: tnt.tnt_edge(),
            full=lambda: tnt.tnt_s()),
    )
}


# ---------------------------------------------------------------------------
# Head-pruned variants (ragged per-layer masks)
# ---------------------------------------------------------------------------

# Reduced-geometry masks: deliberately ragged (uneven surviving-head counts
# across layers) so the pruned variants exercise the schedule's group
# splitting, not just smaller uniform grids.
_PRUNED_MASKS: Dict[str, Any] = {
    # counts per layer: 3, 3, 2, 4 (of 4)
    "vit_edge": ((1, 1, 1, 0), (0, 1, 1, 1), (1, 0, 0, 1), (1, 1, 1, 1)),
    # counts per layer: 2, 2, 1, 3 (of 3)
    "deit_t": ((1, 1, 0), (0, 1, 1), (0, 1, 0), (1, 1, 1)),
    # stage 0 counts 2, 3 (of 3); stage 1 counts 4, 3 (of 6)
    "swin_t": (((1, 0, 1), (1, 1, 1)),
               ((1, 1, 0, 1, 1, 0), (0, 1, 1, 0, 1, 0))),
    # outer-stream counts per layer: 3, 2 (of 4); the inner stream stays
    # dense
    "tnt_s": ((1, 1, 1, 0), (0, 1, 0, 1)),
}


def uniform_head_mask(cfg: Any, k: int) -> Any:
    """A mask keeping the first ``min(k, heads)`` heads of every layer
    (per stage for Swin; TNT's outer stream only, ViT-shaped)."""
    def row(h: int) -> Tuple[int, ...]:
        keep = max(1, min(int(k), h))
        return (1,) * keep + (0,) * (h - keep)
    if isinstance(cfg, swin.SwinConfig):
        return tuple(tuple(row(h) for _ in range(d))
                     for d, h in zip(cfg.depths, cfg.heads))
    return tuple(row(cfg.heads) for _ in range(cfg.layers))


def ragged_head_mask(cfg: Any) -> Any:
    """Deterministic ragged mask for any registered config: layer ``li``
    drops ``li % min(heads, 3)`` heads at rotating positions (at least one
    head always survives; TNT's outer stream only, ViT-shaped).  The
    full-geometry pruned variants use it."""
    def row(h: int, li: int) -> Tuple[int, ...]:
        drop = li % min(h, 3)
        dead = {(li + j) % h for j in range(drop)}
        return tuple(0 if i in dead else 1 for i in range(h))
    if isinstance(cfg, swin.SwinConfig):
        li, stages = 0, []
        for d, h in zip(cfg.depths, cfg.heads):
            stages.append(tuple(row(h, li + j) for j in range(d)))
            li += d
        return tuple(stages)
    return tuple(row(cfg.heads, li) for li in range(cfg.layers))


def _pruned_entry(base: str) -> VisionModel:
    entry = _REGISTRY[base]

    def reduced(_e=entry, _b=base):
        cfg = _e.reduced()
        return dataclasses.replace(cfg, name=cfg.name + "p",
                                   head_mask=_PRUNED_MASKS[_b])

    def full(_e=entry):
        cfg = _e.full()
        return dataclasses.replace(cfg, name=cfg.name + "p",
                                   head_mask=ragged_head_mask(cfg))

    return VisionModel(
        name=base + "_p", family=entry.family,
        description=f"head-pruned {base}: ragged per-layer mask; surviving "
                    "heads equal the dense model's (sliced at init)",
        reduced=reduced, full=full)


for _base in ("vit_edge", "deit_t", "swin_t", "tnt_s"):
    _REGISTRY[_base + "_p"] = _pruned_entry(_base)
del _base


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> VisionModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown vision model {name!r}; registered: "
                       f"{', '.join(list_models())}")
    return _REGISTRY[name]


def build_cfg(name: str, *, full: bool = False,
              fused: Optional[bool] = None,
              fuse_group: Optional[int] = None,
              head_mask: Optional[Any] = None) -> Any:
    """The registered config, reduced or full; ``fused``, ``fuse_group``
    and ``head_mask`` (family-shaped: per stage for Swin, the outer
    stream's for TNT) override the config's own fields when given."""
    entry = get(name)
    cfg = (entry.full if full else entry.reduced)()
    if fused is not None:
        cfg = dataclasses.replace(cfg, fused=fused)
    if fuse_group is not None:
        cfg = dataclasses.replace(cfg, fuse_group=int(fuse_group))
    if head_mask is not None:
        cfg = dataclasses.replace(cfg, head_mask=head_mask)
    return cfg


# ---------------------------------------------------------------------------
# Family-generic dispatch (on config type)
# ---------------------------------------------------------------------------


def _family_mod(cfg: Any):
    if isinstance(cfg, swin.SwinConfig):
        return swin
    if isinstance(cfg, tnt.TNTConfig):
        return tnt
    if isinstance(cfg, vit.ViTConfig):
        return vit
    raise TypeError(f"not a registered vision config: {type(cfg)!r}")


def forward_fn(cfg: Any) -> Callable:
    """(params, patches, cfg, observer=None) -> logits for this family."""
    return _family_mod(cfg).forward


def init_params(cfg: Any, seed: int = 0, device="cpu") -> Any:
    return _family_mod(cfg).init_params(cfg, seed, device)


def make_schedule(cfg: Any) -> sched_lib.Schedule:
    return _family_mod(cfg).schedule(cfg)


def make_spec(cfg: Any):
    """The perfmodel `VisionModelSpec` for this config (the same stage
    description the schedule compiler and the analytic model read)."""
    return _family_mod(cfg).to_spec(cfg)


def quantize(params: Any) -> Any:
    """int8 PTQ, one convention across families (`core.quant`)."""
    return quantize_vision_params(params)
