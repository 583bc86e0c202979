"""Parameter initialisers (counterpart of `repro/models/layers.py`)."""

from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """(d_in, d_out) float32 weights ~ N(0, 1/d_in), drawn on the CPU from
    ``gen`` so every device gets the same numbers for the same seed."""
    return torch.randn((d_in, d_out), generator=gen,
                       dtype=torch.float32) * (1.0 / math.sqrt(d_in))
