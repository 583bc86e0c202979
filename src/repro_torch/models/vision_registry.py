"""Registry of the vision models the port serves (counterpart of
`repro/models/vision_registry.py`): the ViT family (`vit_edge`, `deit_t`)
and Swin-T (`swin_t`).

Each entry has a ``reduced`` geometry (what the CPU tests run) and the
paper's ``full`` one (what runs on the card).  The family-generic helpers
(`forward_fn`, `init_params`, `make_schedule`, `quantize`) dispatch on the
config type, so the server stays model-agnostic.  TNT and the head-pruned
variants come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core import schedule as sched_lib
from repro_torch.core.quant import quantize_vision_params
from repro_torch.models import swin, vit


@dataclasses.dataclass(frozen=True)
class VisionModel:
    name: str
    family: str                       # "vit" | "swin"
    description: str
    reduced: Callable[[], Any]        # -> ViTConfig | SwinConfig
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
    )
}


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> VisionModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown vision model {name!r}; registered: "
                       f"{', '.join(list_models())}")
    return _REGISTRY[name]


def build_cfg(name: str, *, full: bool = False,
              fused: Optional[bool] = None) -> Any:
    """The registered config, reduced or full; ``fused`` overrides the
    config's own fusion flag when given."""
    entry = get(name)
    cfg = (entry.full if full else entry.reduced)()
    if fused is not None:
        cfg = dataclasses.replace(cfg, fused=fused)
    return cfg


# ---------------------------------------------------------------------------
# Family-generic dispatch (on config type)
# ---------------------------------------------------------------------------


def _family_mod(cfg: Any):
    if isinstance(cfg, swin.SwinConfig):
        return swin
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


def quantize(params: Any) -> Any:
    """int8 PTQ, one convention across families (`core.quant`)."""
    return quantize_vision_params(params)
