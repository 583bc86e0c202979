"""Registry of the vision models the port serves (counterpart of
`repro/models/vision_registry.py`; the ViT family for now).

Each entry has a ``reduced`` geometry (what the CPU tests run) and the
paper's ``full`` one (what runs on the card).  Swin, TNT and the
head-pruned variants come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.models import vit


@dataclasses.dataclass(frozen=True)
class VisionModel:
    name: str
    family: str
    description: str
    reduced: Callable[[], vit.ViTConfig]
    full: Callable[[], vit.ViTConfig]


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
    )
}


def list_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get(name: str) -> VisionModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown vision model {name!r}; registered: "
                       f"{', '.join(list_models())}")
    return _REGISTRY[name]


def build_cfg(name: str, *, full: bool = False) -> vit.ViTConfig:
    entry = get(name)
    return (entry.full if full else entry.reduced)()


