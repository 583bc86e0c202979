"""Parameter initialisers (counterpart of `repro/models/layers.py`) and
the move of a param tree between devices."""

from __future__ import annotations

import math
from typing import Any

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """(d_in, d_out) float32 weights ~ N(0, 1/d_in), drawn on the CPU from
    ``gen`` so every device gets the same numbers for the same seed."""
    return torch.randn((d_in, d_out), generator=gen,
                       dtype=torch.float32) * (1.0 / math.sqrt(d_in))


def to_device(tree: Any, device) -> Any:
    """Move a param tree (dicts, lists, tensors, `QTensor`s) to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
