"""Architecture registry and the shape cells (counterpart of
`repro/configs/registry.py`).

`input_specs` and the ``*_inputs`` helpers of the JAX registry build
`jax.ShapeDtypeStruct` stand-ins for the dry run; they wait for the port
of the dry run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "internvl2-26b": "internvl2_26b",
    "qwen2.5-32b": "qwen2_5_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "stablelm-3b": "stablelm_3b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
    "hubert-xlarge": "hubert_xlarge",
}


def list_archs():
    return list(_ARCH_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}; registered: "
                       f"{', '.join(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    cell = SHAPES[shape]
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch: no autoregressive decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "outside the family's operating regime")
    return True, ""
