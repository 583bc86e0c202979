"""int8 post-training quantization (counterpart of `repro/core/quant.py`).

Symmetric int8 (zero point 0): per-(head, out-channel) for the per-head
QKV stacks, per-output-channel for plain matmul weights, per-tensor for
activations, with max-abs calibration.  The arithmetic follows the JAX
module step for step, so the same float weights give the same int8 codes
and scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

INT8_MAX = 127.0


@dataclasses.dataclass
class QTensor:
    """int8 ``values`` + float32 ``scale`` broadcastable against them."""

    values: torch.Tensor
    scale: torch.Tensor

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scale.to(device))


def amax_scale(x: torch.Tensor, dim=None, eps: float = 1e-8) -> torch.Tensor:
    """Symmetric scale from max-abs statistics (keepdims over ``dim``)."""
    a = x.abs()
    amax = a.amax() if dim is None else a.amax(dim=dim, keepdim=True)
    return torch.clamp(amax, min=eps) / INT8_MAX


def quantize(x: torch.Tensor, scale: torch.Tensor) -> QTensor:
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return QTensor(q, scale.float())


def quantize_per_channel(w: torch.Tensor) -> QTensor:
    """Per-output-channel (last axis) symmetric quantization of a weight
    matrix."""
    return quantize(w, amax_scale(w, dim=tuple(range(w.ndim - 1))))


_PER_HEAD_KEYS = frozenset({"wq", "wk", "wv"})
_PER_CHANNEL_KEYS = frozenset({"patch_embed", "head", "w_msa", "w_up",
                               "w_down", "merge_w"})


def quantize_vision_params(params: Any) -> Any:
    """int8 PTQ of a ViT or Swin param tree: per-head ``wq/wk/wv`` stacks
    reduce over the contraction dim D only (scale (H, 1, Dh));
    ``patch_embed``, ``head``, ``w_msa``, ``w_up``, ``w_down`` and Swin's
    ``merge_w`` are per output channel (scale (1, N)); norms, biases, the
    relative-position bias tables and the positional embedding stay
    float."""

    def _q(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in _PER_HEAD_KEYS:
                    out[k] = quantize(v, amax_scale(v, dim=(1,)))
                elif k in _PER_CHANNEL_KEYS:
                    out[k] = quantize_per_channel(v)
                elif isinstance(v, (dict, list)):
                    out[k] = _q(v)
                else:
                    out[k] = v
            return out
        if isinstance(node, list):
            return [_q(v) for v in node]
        return node

    return _q(params)


class Calibrator:
    """Per-site activation amax, recorded during calibration forwards.

    ``observe(name, x)`` records max|x| while calibrating (a host sync per
    call) and returns the running scale; once frozen it returns the frozen
    0-d float32 scale, which lives on the calibrator's device."""

    def __init__(self):
        self.amax: Dict[str, float] = {}
        self.frozen: Optional[Dict[str, torch.Tensor]] = None

    def observe(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.frozen is not None:
            return self.frozen[name]
        a = float(x.abs().amax())
        self.amax[name] = max(self.amax.get(name, 0.0), a)
        return torch.tensor(max(self.amax[name], 1e-8) / INT8_MAX,
                            dtype=torch.float32, device=x.device)

    def freeze(self, device="cpu") -> Dict[str, torch.Tensor]:
        self.frozen = {k: torch.tensor(max(v, 1e-8) / INT8_MAX,
                                       dtype=torch.float32, device=device)
                       for k, v in self.amax.items()}
        return self.frozen

    def to(self, device) -> "Calibrator":
        """A frozen copy whose scales live on ``device``."""
        if self.frozen is None:
            raise RuntimeError("only a frozen calibrator can move devices")
        out = Calibrator()
        out.amax = dict(self.amax)
        out.frozen = {k: v.to(device) for k, v in self.frozen.items()}
        return out


# The PTQ acceptance gate shared with the reference:
# max|logit_float - logit_int8| <= PTQ_REL_TOL * max|logit_float| + PTQ_ABS_TOL
PTQ_REL_TOL = 0.1
PTQ_ABS_TOL = 0.05


def ptq_tolerance(float_logit_scale: float) -> float:
    """Tolerance on int8 logit error, given max|float logits|."""
    return PTQ_REL_TOL * float(float_logit_scale) + PTQ_ABS_TOL
