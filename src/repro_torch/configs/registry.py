"""Architecture registry and the shape cells (counterpart of
`repro/configs/registry.py`).

40 nominal (arch x shape) cells; `all_cells` yields each with whether it
applies and why not (an encoder-only arch has no decode step; a pure
full-attention arch skips ``long_500k``).  `input_specs` and the
``*_inputs`` helpers give each cell's inputs as meta tensors (shapes and
dtypes, no storage), where the JAX registry gives `ShapeDtypeStruct`s;
decode caches come in the port's flat per-layer layout.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

import torch

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


def all_cells():
    """Every (arch, shape, applies, why-not) cell."""
    for arch in list_archs():
        cfg = get(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            yield arch, shape, ok, why


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins (no allocation) per cell
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    b, s = cell.global_batch, cell.seq_len
    dt, i32 = cfg.param_dtype, torch.int32
    if cfg.input_mode == "tokens":
        return {"tokens": _meta((b, s), i32), "labels": _meta((b, s), i32)}
    if cfg.input_mode == "tokens+image":
        st = s - cfg.n_image_tokens
        return {"tokens": _meta((b, st), i32),
                "patch_embeds": _meta((b, cfg.n_image_tokens, cfg.d_model),
                                      dt),
                "labels": _meta((b, st), i32)}
    # embeds (audio stub frontend)
    return {"embeds": _meta((b, s, cfg.d_model), dt),
            "labels": _meta((b, s), i32)}


def prefill_inputs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    return train_inputs(cfg, cell)


def decode_inputs(cfg: ModelConfig, cell: ShapeCell
                  ) -> Tuple[Dict[str, Any], Any]:
    """({tokens, pos}, caches): the caches one per layer, as
    `transformer.init_caches` lays them out."""
    from repro_torch.models import transformer as tr
    b = cell.global_batch
    caches = tr.init_caches(cfg, b, cell.seq_len, device="meta")
    return ({"tokens": _meta((b,), torch.int32),
             "pos": _meta((b,), torch.int32)}, caches)


def input_specs(arch: str, shape: str):
    """Meta-tensor stand-ins for an (arch, shape) cell's inputs."""
    cfg = get(arch)
    cell = SHAPES[shape]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape} skipped: {why}")
    if cell.kind == "train":
        return train_inputs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_inputs(cfg, cell)
    return decode_inputs(cfg, cell)
