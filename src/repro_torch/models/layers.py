"""Shared model building blocks (counterpart of `repro/models/layers.py`):
initialisers, norms, RoPE, the LM attention block with its (ring) KV
cache, the dense / gated MLP, the top-k capacity-factor MoE feed-forward,
and the move of a param tree between devices.

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

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops, ref

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands in for a `torch.Generator` on the meta device, where none
    can live: `randn` and `rand` then allocate shapes without values (the
    dry run's zero-allocation param trees)."""

    device = torch.device("meta")


def generator(seed: int, device=None):
    """A generator seeded with ``seed`` on ``device`` (the CPU when None),
    or a `MetaGenerator` on the meta device."""
    if device is not None and torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device or "cpu").manual_seed(seed)


def randn(gen, shape) -> torch.Tensor:
    """float32 N(0, 1) draws of ``shape`` on ``gen``'s device (no values
    on meta)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def rand(gen, shape) -> torch.Tensor:
    """float32 U(0, 1) draws of ``shape`` on ``gen``'s device (no values
    on meta)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) weights ~ N(0, 1/d_in), drawn in float32 on
    ``gen``'s device and cast to ``dtype``."""
    return (randn(gen, (d_in, d_out)) * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (randn(gen, (vocab, d)) * 0.02).to(dtype)


def cast_params(tree: Any, dtype: torch.dtype) -> Any:
    """A param tree (dicts, lists, tensors) with every tensor cast to
    ``dtype``."""
    return tree_lib.tree_map(lambda t: t.to(dtype), tree)


def to_device(tree: Any, device) -> Any:
    """Move a param tree (dicts, lists, tensors, `QTensor`s) to ``device``."""
    return tree_lib.tree_map(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 returning x's dtype (`ops.layer_norm`)."""
    return ops.layer_norm(x, w, b, eps)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the (1 + w) scale; returns x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + w.float())).to(x.dtype)


# The mixed-precision VJPs of the JAX package (`layers.py`'s custom_vjp
# trio).  Each backward returns the cotangent in x's dtype; the JAX
# package also barriers it (`optimization_barrier`, so a tensor-parallel
# partial sum resolves in that dtype), which has no counterpart in eager
# PyTorch: the values are the same without it.


class _RmsNormMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xf = x.float()
        r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                        + 1e-6)
        ctx.save_for_backward(x, w, r)
        return (xf * r * (1.0 + w.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, r = ctx.saved_tensors
        gf = g.float()
        xn = x.float() * r
        gw = gf * (1.0 + w.float())
        m = torch.mean(gw * xn, dim=-1, keepdim=True)
        dx = ((gw - xn * m) * r).to(x.dtype)
        dw = torch.sum(gf * xn, dim=tuple(range(g.dim() - 1)))
        return dx, dw.to(w.dtype)


class _CotangentIn(torch.autograd.Function):
    """``cast(x)`` forward; the cotangent back in x's dtype."""

    @staticmethod
    def forward(ctx, x, to_f32: bool):
        ctx.dtype = x.dtype
        y = x.float() if to_f32 else x
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def rms_norm_mp(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`rms_norm` whose backward takes the incoming cotangent in its own
    dtype and runs the norm's backward in float32 (the JAX package's
    `rms_norm_mp`); dx in x's dtype, dw in w's."""
    return _RmsNormMP.apply(x, w)


def cast_f32_mp(x: torch.Tensor) -> torch.Tensor:
    """A cast to float32 whose backward returns the cotangent in x's
    dtype (the JAX package's `cast_f32_mp`: an f32 side path such as the
    MoE router does not promote the activation cotangent)."""
    return _CotangentIn.apply(x, True)


def clamp_cotangent(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward re-expresses the cotangent in x's dtype
    (the JAX package's `clamp_cotangent`, at block boundaries)."""
    return _CotangentIn.apply(x, False)


def norm_init(d: int, kind: str, dtype: torch.dtype, device=None) -> Params:
    if kind == "rms":
        return {"w": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(x: torch.Tensor, p: Params, kind: str) -> torch.Tensor:
    if kind == "rms":
        return rms_norm(x, p["w"])
    if kind == "rms_mp":
        return rms_norm_mp(x, p["w"])
    if kind == "ln":
        return ops.layer_norm(x, p["w"], p["b"])
    raise ValueError(f"unknown norm {kind!r}")


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


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-factor dispatch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    n_experts: int
    top_k: int
    activation: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25
    # Virtual-expert expansion: each expert split into ``ep_virtual``
    # slices along d_ff, gates repeated and the slices summed in the
    # combine (the identity; in the JAX package it makes the expert count
    # divide a model axis).
    ep_virtual: int = 1


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype) -> Params:
    """``router`` (D, E) in float32; ``w_up``, ``w_gate`` (E, D, F) and
    ``w_down`` (E, F, D), each expert drawn as a `dense_init`."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def stack(d_in, d_out):
        return torch.stack([dense_init(gen, d_in, d_out, dtype)
                            for _ in range(e)])

    p = {"router": dense_init(gen, d, e, torch.float32),
         "w_up": stack(d, f), "w_down": stack(f, d)}
    if cfg.gated:
        p["w_gate"] = stack(d, f)
    return p


def moe_route(p: Params, x: torch.Tensor, k_top: int):
    """The router: (probs (G, S, E) float32, gate values (G, S, k)
    renormalised over the k chosen, expert ids (G, S, k) int64).  The top
    k come from a stable descending sort, so ties go to the lower expert
    id, as `jax.lax.top_k` breaks them, on every device."""
    probs = torch.softmax(cast_f32_mp(x) @ p["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k_top], idx[..., :k_top]
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), gate_idx


def _split_cols(w: torch.Tensor, v: int) -> torch.Tensor:
    """(E, D, F) -> (E*v, D, F/v), slicing F."""
    e, d, f = w.shape
    return w.reshape(e, d, v, f // v).permute(0, 2, 1, 3).reshape(
        e * v, d, f // v)


def moe_forward(p: Params, x: torch.Tensor, cfg: MoEConfig,
                return_aux: bool = False):
    """Top-k capacity-factor MoE with scatter/gather dispatch (the JAX
    package's `moe_forward`, step for step).

    x: (B, T, D); the batch dim is the dispatch group.  Each expert takes
    at most ``cap = min(max(int(capacity_factor * T * k / E), 1), T)``
    (token, choice) pairs of a group, queued in (token, choice) order; the
    rest are dropped (their share of the output is zero; the residual
    passes).  The experts are batched products (`torch.einsum`), as in
    the JAX package, where they sit outside any Pallas kernel.  The JAX
    package's sharding hints are no-ops off a mesh and the port has no LM
    mesh, so there are none here.  With ``return_aux`` also the
    Switch-style load-balance loss over the parent experts' top-1
    choices."""
    g, s, d = x.shape
    e, k_top = cfg.n_experts, cfg.top_k
    cap = min(max(int(cfg.capacity_factor * s * k_top / e), 1), s)

    probs, gate_vals, gate_idx = moe_route(p, x, k_top)
    parent_idx = gate_idx

    v = cfg.ep_virtual
    w_up, w_down, w_gate = p["w_up"], p["w_down"], p.get("w_gate")
    if v > 1:
        if cfg.d_ff % v:
            raise ValueError(f"ep_virtual {v} does not divide d_ff "
                             f"{cfg.d_ff}")
        gate_idx = (gate_idx[..., None] * v + torch.arange(
            v, device=x.device)).reshape(g, s, k_top * v)
        gate_vals = torch.repeat_interleave(gate_vals, v, dim=-1)
        e, k_top = e * v, k_top * v
        w_up = _split_cols(w_up, v)
        if w_gate is not None:
            w_gate = _split_cols(w_gate, v)
        ee, ff, dd = w_down.shape
        w_down = w_down.reshape(ee * v, ff // v, dd)

    # Position of each (token, choice) in its expert's queue (per group):
    # an exclusive cumsum over the flattened (token, choice) order.
    onehot = torch.nn.functional.one_hot(gate_idx, e)       # (G, S, k, E)
    flat = onehot.reshape(g, s * k_top, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, s, k_top, e)
    pos = (pos * onehot).sum(-1)                            # (G, S, k)
    keep = pos < cap

    # Scatter each kept (token, choice) into its (expert, slot) cell; a
    # dropped one goes to the sentinel column E*cap, sliced away.
    slot = torch.where(keep, gate_idx * cap + pos, e * cap)  # (G, S, k)
    sidx = torch.arange(s, device=x.device)[None, :, None].expand(g, s,
                                                                  k_top)
    src = torch.full((g, e * cap + 1), s, dtype=torch.int64,
                     device=x.device)                       # sentinel = S
    src.scatter_(1, slot.reshape(g, -1), sidx.reshape(g, -1))
    src = src[:, :e * cap]                                  # (G, E*C)

    # Gather tokens to expert slots; the zero row S fills empty slots.
    xpad = torch.cat([x, x.new_zeros((g, 1, d))], dim=1)
    expert_in = torch.gather(xpad, 1, src[..., None].expand(-1, -1, d)
                             ).reshape(g, e, cap, d)        # (G, E, C, D)

    act = ref.act_fn(cfg.activation)
    h = torch.einsum("gecd,edf->gecf", expert_in, w_up)
    if cfg.gated:
        gt = torch.einsum("gecd,edf->gecf", expert_in, w_gate)
        h = act(gt.float()).to(h.dtype) * h
    else:
        h = act(h.float()).to(h.dtype)
    expert_out = torch.einsum("gecf,efd->gecd", h, w_down)

    # Combine: gather each token's k slots back and gate-weight them, the
    # sum in x's dtype.
    flat_out = torch.cat([expert_out.reshape(g, e * cap, d),
                          expert_out.new_zeros((g, 1, d))], dim=1)
    y = torch.gather(flat_out, 1, slot.reshape(g, s * k_top, 1).expand(
        -1, -1, d)).reshape(g, s, k_top, d)
    y = (y * gate_vals[..., None].to(y.dtype)).sum(dim=2).to(x.dtype)
    if not return_aux:
        return y
    # Switch-style load-balance loss from the router's statistics, over
    # the parent experts (the virtual expansion is an execution detail).
    top1 = parent_idx[..., 0].reshape(-1)
    frac_tokens = torch.nn.functional.one_hot(
        top1, cfg.n_experts).float().mean(0)
    frac_probs = probs.reshape(-1, cfg.n_experts).mean(0)
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum()
    return y, aux
