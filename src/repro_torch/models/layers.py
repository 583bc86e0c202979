"""Shared model building blocks (counterpart of `repro/models/layers.py`):
initialisers, norms, RoPE, the LM attention block with its (ring) KV
cache, the dense / gated MLP, and the move of a param tree between
devices.

Parameters are nested dicts of tensors; weight matrices are 2-D
(d_in, d_out).  The attention kernels and the fused MLP are reached
through `repro_torch.kernels.ops`, so a CUDA tensor runs the port's
kernels and a CPU tensor their plain versions.  Random weights are drawn
on the generator's device: a seed gives other numbers on the card than on
the CPU, so a comparison across devices copies one tree to the other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) weights ~ N(0, 1/d_in), drawn in float32 on
    ``gen``'s device and cast to ``dtype``."""
    return (torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=gen.device)
            * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


def cast_params(tree: Any, dtype: torch.dtype) -> Any:
    """A param tree (dicts, lists, tensors) with every tensor cast to
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype) for v in tree]
    return tree.to(dtype)


def to_device(tree: Any, device) -> Any:
    """Move a param tree (dicts, lists, tensors, `QTensor`s) to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the (1 + w) scale; returns x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


def norm_init(d: int, kind: str, dtype: torch.dtype, device=None) -> Params:
    if kind == "rms":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["w"])
    if kind == "ln":
        return ops.layer_norm(x, p["w"], p["b"])
    raise NotImplementedError(
        f"norm {kind!r} is not ported (rms_mp is the training side's)")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rope_dim: Optional[int] = None) -> torch.Tensor:
    """Half-split rotary embedding over the first ``rope_dim`` (default:
    all) channels.  x: (B, H, T, Dh) with positions (B, T), or (B, H, Dh)
    with positions (B,).  Angles in float32; returns x's dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[:, :, None]
        positions = positions[:, None]
    dh = x.shape[-1]
    rd = rope_dim or dh
    half = rd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None, :, None].float() * freqs      # (B, 1, T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:rd]
    xr1 = x1 * cos - x2 * sin
    xr2 = x2 * cos + x1 * sin
    out = torch.cat([xr1.to(x.dtype), xr2.to(x.dtype), x[..., rd:]], dim=-1)
    return out[:, :, 0] if squeeze else out


# ---------------------------------------------------------------------------
# Attention (GQA / sliding window / QKV bias)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: Optional[int] = None       # sliding-window size (SWA)
    causal: bool = True
    rope_theta: Optional[float] = 10000.0  # None -> no RoPE (encoders)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              dtype: torch.dtype) -> Params:
    p = {"wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
         "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
         "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
         "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                        ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int,
                 head_dim: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n_heads, head_dim).transpose(1, 2).contiguous()


def _qkv(p: Params, x: torch.Tensor, cfg: AttnConfig):
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _heads_roped(p: Params, x: torch.Tensor, cfg: AttnConfig):
    """(B, T, D) -> q (B, Hq, T, Dh), k, v (B, Hkv, T, Dh), contiguous,
    q and k rotated at positions 0..T-1."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta is not None:
        positions = torch.arange(t, device=x.device).expand(b, t)
        q = rope(q, positions, cfg.rope_theta).contiguous()
        k = rope(k, positions, cfg.rope_theta).contiguous()
    return q, k, v


def _merge_heads_out(p: Params, o: torch.Tensor,
                     cfg: AttnConfig) -> torch.Tensor:
    b, _, t, _ = o.shape
    return o.transpose(1, 2).reshape(b, t, cfg.q_dim) @ p["wo"]


def attn_forward(p: Params, x: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """Full-sequence attention (prefill without the cache)."""
    q, k, v = _heads_roped(p, x, cfg)
    o = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window)
    return _merge_heads_out(p, o, cfg)


def attn_prefill(p: Params, x: torch.Tensor, cfg: AttnConfig,
                 cache_len: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill: attention and the (possibly ring) KV cache of length
    ``cache_len``.  k and v are projected once and serve both (the JAX
    package projects them twice, to the same values)."""
    t = x.shape[1]
    q, k, v = _heads_roped(p, x, cfg)
    o = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window)
    if t >= cache_len:
        # Ring layout: absolute position p lives at slot p % cache_len, so
        # the kept tail is rolled by t mod cache_len.
        k_c = torch.roll(k[:, :, -cache_len:], t % cache_len, dims=2)
        v_c = torch.roll(v[:, :, -cache_len:], t % cache_len, dims=2)
    else:
        pad = (0, 0, 0, cache_len - t)
        k_c = torch.nn.functional.pad(k, pad)
        v_c = torch.nn.functional.pad(v, pad)
    return _merge_heads_out(p, o, cfg), {"k": k_c.contiguous(),
                                         "v": v_c.contiguous()}


def attn_decode(p: Params, x: torch.Tensor, cache: Dict[str, Any],
                pos: torch.Tensor, cfg: AttnConfig
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode step.  x: (B, D); pos: (B,) absolute positions;
    cache k/v: (B, Hkv, S, Dh), a ring of S slots (slot = pos % S).  The
    new key and value are written into the cache IN PLACE (the JAX package
    returns new arrays), and the same dict is returned."""
    b = x.shape[0]
    s = cache["k"].shape[2]
    q, k, v = _qkv(p, x, cfg)
    q = q.reshape(b, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta is not None:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    slot = (pos % s).long()
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, :, slot] = k
    cache["v"][bidx, :, slot] = v
    lengths = torch.clamp(pos + 1, max=s).to(torch.int32)
    o = ops.decode_attention(q.contiguous(), cache["k"], cache["v"], lengths)
    return o.reshape(b, cfg.q_dim) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLP (dense, gated, squared-ReLU): the fused kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "gelu"
    gated: bool = False
    bias: bool = False


def mlp_init(gen: torch.Generator, cfg: MlpConfig,
             dtype: torch.dtype) -> Params:
    p = {"w_up": dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
         "w_down": dense_init(gen, cfg.d_ff, cfg.d_model, dtype)}
    if cfg.gated:
        p["w_gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, dtype)
    if cfg.bias:
        p["b_up"] = torch.zeros((cfg.d_ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device)
    return p


def mlp_forward(p: Params, x: torch.Tensor, cfg: MlpConfig) -> torch.Tensor:
    return ops.mlp(x, p["w_up"], p["w_down"], p.get("b_up"),
                   p.get("b_down"), p.get("w_gate"),
                   activation=cfg.activation)
