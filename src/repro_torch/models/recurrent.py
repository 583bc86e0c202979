"""RG-LRU recurrent mixer of RecurrentGemma / Griffin (counterpart of
`repro/models/recurrent.py`).

The block: x -> {gate branch: linear + GELU} x {recurrence branch: linear
-> causal depthwise conv -> RG-LRU} -> product -> output linear.  Prefill
and forward run the recurrence through `ops.linear_recurrence` (the
`rglru_scan` kernel on the card); decode is the O(1) update in plain
torch.  The gate coefficients are computed in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from .config import ModelConfig
from .layers import Params, dense_init, rand, randn

C_RGLRU = 8.0


def rec_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> Params:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    dev = gen.device
    return {
        "w_x": dense_init(gen, d, w, dtype),
        "w_gate_branch": dense_init(gen, d, w, dtype),
        "w_out": dense_init(gen, w, d, dtype),
        # depthwise causal conv
        "conv_w": (randn(gen, (cfg.conv_width, w)) * 0.1).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        # RG-LRU gates + Lambda
        "w_input_gate": dense_init(gen, w, w, dtype),
        "w_rec_gate": dense_init(gen, w, w, dtype),
        "a_param": 0.744 + (0.963 - 0.744) * rand(gen, (w,)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype.  x: (B, T, W); w: (K, W);
    state: (B, K-1, W), the K-1 inputs before x (zeros when None)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i][None, None] for i in range(k))
    return out + b, xp[:, -(k - 1):].contiguous()


def _rglru_coeffs(p: Params, xw: torch.Tensor):
    """a_t and the scaled input of the linear recurrence (float32)."""
    xf = xw.float()
    gate_in = torch.sigmoid(xf @ p["w_input_gate"].float())
    gate_rec = torch.sigmoid(xf @ p["w_rec_gate"].float())
    log_a = -C_RGLRU * F.softplus(p["a_param"].float()) * gate_rec
    a_t = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.square(a_t), min=1e-12))
    return a_t, mult * (gate_in * xf)


def _assoc_scan(a_t: torch.Tensor, inp: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + inp_t with h_{-1} = h0, through
    `ops.linear_recurrence` (h0 folded into the first input)."""
    inp = inp.clone()
    inp[:, 0] += a_t[:, 0] * h0
    return ops.linear_recurrence(a_t, inp)


def _gate(p: Params, x: torch.Tensor) -> torch.Tensor:
    return ref.gelu((x @ p["w_gate_branch"]).float())


def _rec_sequence(p: Params, x: torch.Tensor):
    """(output, h, conv state) of the block over the whole sequence."""
    gate = _gate(p, x)
    xw, conv_state = _causal_conv(x @ p["w_x"], p["conv_w"], p["conv_b"])
    a_t, inp = _rglru_coeffs(p, xw)
    h0 = torch.zeros((x.shape[0], inp.shape[-1]), dtype=torch.float32,
                     device=x.device)
    h = _assoc_scan(a_t, inp, h0)
    y = (h * gate).to(x.dtype)
    return y @ p["w_out"], h, conv_state


def rec_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _rec_sequence(p, x)[0]


def rec_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rec_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, cache_len: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out, h, conv_state = _rec_sequence(p, x)
    return out, {"h": h[:, -1].contiguous(), "conv": conv_state}


def rec_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, D), one token: the O(1) update of h and the conv state."""
    gate = _gate(p, x)
    xw1, conv_state = _causal_conv((x @ p["w_x"])[:, None], p["conv_w"],
                                   p["conv_b"], cache["conv"])
    a_t, inp = _rglru_coeffs(p, xw1)
    h = a_t[:, 0] * cache["h"] + inp[:, 0]
    y = (h * gate).to(x.dtype)
    return y @ p["w_out"], {"h": h, "conv": conv_state}
