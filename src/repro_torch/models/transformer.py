"""The LM backbone (counterpart of `repro/models/transformer.py`) for the
``attn`` and ``rec`` block kinds.

A model is ``n_layers`` pre-norm residual blocks following the repeating
``pattern`` of kinds:

    x += mixer(norm(x))
    x += mlp(norm(x))          # when d_ff > 0

The JAX package stacks each pattern position's parameters over the
superblocks and scans; here ``params["layers"]`` is the flat list of the
``n_layers`` blocks in order (layer i is pattern position i % P of
superblock i // P) and the scan is a Python loop.  Caches are a list in
the same order.  `convert.lm_params_from_numpy` carries a JAX tree over.

Entry points: `forward` (logits of every position), `prefill` (the last
position's logits and the caches) and `decode_step` (one token per
sequence).  The ``mlstm`` and ``slstm`` kinds, MoE feed-forwards and the
``embeds`` / ``tokens+image`` input modes raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import recurrent
from .config import ModelConfig
from .layers import (AttnConfig, MlpConfig, Params, apply_norm, attn_decode,
                     attn_forward, attn_init, attn_prefill, dense_init,
                     embed_init, mlp_forward, mlp_init, norm_init)

PORTED_KINDS = ("attn", "rec")


def check_supported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` naming what of ``cfg`` is not ported."""
    missing = sorted(set(cfg.pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {missing} (models/xlstm.py) are not "
            f"ported yet; the port runs {list(PORTED_KINDS)}")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the MoE feed-forward (layers.moe_forward) is not "
            f"ported yet")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: input mode {cfg.input_mode!r} is not ported yet; "
            f"the port embeds tokens only")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each of the ``n_layers`` layers, in order."""
    return [cfg.pattern[i % len(cfg.pattern)]
            for i in range(cfg.n_superblocks * len(cfg.pattern))]


def _attn_cfg(cfg: ModelConfig) -> AttnConfig:
    return AttnConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                      qkv_bias=cfg.qkv_bias, window=cfg.window,
                      causal=cfg.causal, rope_theta=cfg.rope_theta)


def _mlp_cfg(cfg: ModelConfig) -> MlpConfig:
    return MlpConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     activation=cfg.activation, gated=cfg.gated,
                     bias=cfg.mlp_bias)


def _has_ff(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _block_init(kind: str, gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype, dev = cfg.param_dtype, gen.device
    mixer = (attn_init(gen, _attn_cfg(cfg), dtype) if kind == "attn"
             else recurrent.rec_init(gen, cfg, dtype))
    p: Params = {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
                 "mixer": mixer}
    if _has_ff(cfg):
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        p["mlp"] = mlp_init(gen, _mlp_cfg(cfg), dtype)
    return p


def _ff(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if not _has_ff(cfg):
        return x
    return x + mlp_forward(p["mlp"], apply_norm(x, p["norm2"], cfg.norm),
                           _mlp_cfg(cfg))


def _block_forward(kind: str, p: Params, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind == "attn":
        y = attn_forward(p["mixer"], h, _attn_cfg(cfg))
    else:
        y = recurrent.rec_forward(p["mixer"], h, cfg)
    return _ff(p, x + y, cfg)


def _block_prefill(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                   cache_len: int):
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind == "attn":
        y, cache = attn_prefill(p["mixer"], h, _attn_cfg(cfg), cache_len)
    else:
        y, cache = recurrent.rec_prefill(p["mixer"], h, cfg, cache_len)
    return _ff(p, x + y, cfg), cache


def _block_decode(kind: str, p: Params, x: torch.Tensor, cache, pos,
                  cfg: ModelConfig):
    h = apply_norm(x, p["norm1"], cfg.norm)
    if kind == "attn":
        y, cache = attn_decode(p["mixer"], h, cache, pos, _attn_cfg(cfg))
    else:
        y, cache = recurrent.rec_decode(p["mixer"], h, cache, pos, cfg)
    return _ff(p, x + y, cfg), cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the CPU when
    None) in the config's dtype."""
    check_supported(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    dtype = cfg.param_dtype
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "layers": [_block_init(kind, gen, cfg) for kind in layer_kinds(cfg)],
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, gen.device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype)
    return params


def embed_batch(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """Token embedding -> (B, S, D)."""
    check_supported(cfg)
    return params["embed"][batch["tokens"].long()]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, padded_vocab) of every position."""
    x = embed_batch(params, batch, cfg)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x = _block_forward(kind, p, x, cfg)
    return unembed(params, apply_norm(x, params["final_norm"], cfg.norm), cfg)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero cache per layer: attention k/v (B, Hkv, S, Dh) with S =
    ``kv_cache_len(cache_len)``; recurrent h (B, W) float32 and conv
    state (B, K-1, W)."""
    check_supported(cfg)
    dtype, s = cfg.param_dtype, cfg.kv_cache_len(cache_len)
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "attn":
            shape = (batch, cfg.n_kv_heads, s, cfg.hd)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype,
                                            device=device)})
        else:
            caches.append(recurrent.rec_init_cache(cfg, batch, s, dtype,
                                                   device))
    return caches


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt: the last position's logits (B, 1, padded_vocab)
    and the caches."""
    x = embed_batch(params, batch, cfg)
    eff_len = cfg.kv_cache_len(cache_len)
    caches = []
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x, c = _block_prefill(kind, p, x, cfg, eff_len)
        caches.append(c)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return unembed(params, x[:, -1:], cfg), caches


def decode_step(params: Params, tokens: torch.Tensor, caches: List[Dict],
                pos: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """tokens (B,), pos (B,) absolute positions -> logits (B,
    padded_vocab) and the caches after the step (attention caches are
    updated in place, recurrent ones replaced)."""
    check_supported(cfg)
    x = params["embed"][tokens.long()]
    new_caches = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], caches):
        x, c = _block_decode(kind, p, x, c, pos, cfg)
        new_caches.append(c)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return unembed(params, x, cfg), new_caches


def param_count(params: Params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    return count(params)
