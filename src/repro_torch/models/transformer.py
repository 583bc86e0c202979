"""The LM backbone (counterpart of `repro/models/transformer.py`) for every
block kind (``attn``, ``rec``, ``mlstm``, ``slstm``), the dense and MoE
feed-forwards and the three input modes.

A model is ``n_layers`` pre-norm residual blocks following the repeating
``pattern`` of kinds:

    x += mixer(norm(x))
    x += mlp_or_moe(norm(x))   # when d_ff > 0 or the config has MoE

The JAX package stacks each pattern position's parameters over the
superblocks and scans; here ``params["layers"]`` is the flat list of the
``n_layers`` blocks in order (layer i is pattern position i % P of
superblock i // P) and the scan is a Python loop.  Caches are a list in
the same order.  `convert.lm_params_from_numpy` carries a JAX tree over.

Inputs (``input_mode``): ``tokens`` (B, S) through ``embed``;
``tokens+image``: ``patch_embeds`` (B, n_image_tokens, D) ahead of the
embedded tokens; ``embeds``: precomputed frames (B, S, embed_dim_in),
through ``in_proj`` where embed_dim_in differs from d_model.  In decode
an MoE feed-forward is dropless (capacity n_experts / top_k), as in the
JAX package, so serving never drops a token.

Entry points: `forward` (logits of every position, and with
``return_aux`` the summed MoE load-balance loss), `loss_fn` (the
training loss and its metrics), `prefill` (the last position's logits and
the caches) and `decode_step` (one token, or one embedding row in the
``embeds`` mode, per sequence).

Training: ``bf16_reduce`` selects the ``rms_mp`` norm and clamps the
mixer and feed-forward outputs' cotangents to their dtype
(`layers.rms_norm_mp`, `layers.clamp_cotangent`), as in the JAX package;
``remat`` recomputes each superblock in the backward
(`torch.utils.checkpoint`, non-reentrant, where the JAX package wraps
the scan body in `jax.checkpoint`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib

from . import recurrent, xlstm
from .config import ModelConfig
from .layers import (AttnConfig, MlpConfig, MoEConfig, Params, apply_norm,
                     attn_decode, attn_forward, attn_init, attn_prefill,
                     clamp_cotangent, dense_init, embed_init, generator,
                     mlp_forward, mlp_init, moe_forward, moe_init,
                     norm_init)


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


def _moe_cfg(cfg: ModelConfig) -> MoEConfig:
    m = cfg.moe
    return MoEConfig(d_model=cfg.d_model, d_ff=m.d_ff, n_experts=m.n_experts,
                     top_k=m.top_k, activation=cfg.activation,
                     gated=cfg.gated, capacity_factor=m.capacity_factor,
                     ep_virtual=cfg.moe_ep_virtual)


def _has_ff(cfg: ModelConfig) -> bool:
    return cfg.d_ff > 0 or cfg.moe is not None


# ---------------------------------------------------------------------------
# Per-kind mixer dispatch
# ---------------------------------------------------------------------------


def _mixer_init(kind: str, gen: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> Params:
    if kind == "attn":
        return attn_init(gen, _attn_cfg(cfg), dtype)
    if kind == "rec":
        return recurrent.rec_init(gen, cfg, dtype)
    if kind == "mlstm":
        return xlstm.mlstm_init(gen, cfg, dtype)
    if kind == "slstm":
        return xlstm.slstm_init(gen, cfg, dtype)
    raise ValueError(kind)


def _mixer_forward(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig):
    if kind == "attn":
        return attn_forward(p, x, _attn_cfg(cfg))
    if kind == "rec":
        return recurrent.rec_forward(p, x, cfg)
    if kind == "mlstm":
        return xlstm.mlstm_forward(p, x, cfg)
    if kind == "slstm":
        return xlstm.slstm_forward(p, x, cfg)
    raise ValueError(kind)


def _mixer_prefill(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                   cache_len: int):
    if kind == "attn":
        return attn_prefill(p, x, _attn_cfg(cfg), cache_len)
    if kind == "rec":
        return recurrent.rec_prefill(p, x, cfg, cache_len)
    if kind == "mlstm":
        return xlstm.mlstm_prefill(p, x, cfg, cache_len)
    if kind == "slstm":
        return xlstm.slstm_prefill(p, x, cfg, cache_len)
    raise ValueError(kind)


def _mixer_decode(kind: str, p: Params, x: torch.Tensor, cache, pos,
                  cfg: ModelConfig):
    if kind == "attn":
        return attn_decode(p, x, cache, pos, _attn_cfg(cfg))
    if kind == "rec":
        return recurrent.rec_decode(p, x, cache, pos, cfg)
    if kind == "mlstm":
        return xlstm.mlstm_decode(p, x, cache, pos, cfg)
    if kind == "slstm":
        return xlstm.slstm_decode(p, x, cache, pos, cfg)
    raise ValueError(kind)


def _mixer_init_cache(kind: str, cfg: ModelConfig, batch: int, s: int,
                      dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    if kind == "attn":
        shape = (batch, cfg.n_kv_heads, s, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "rec":
        return recurrent.rec_init_cache(cfg, batch, s, dtype, device)
    if kind == "mlstm":
        return xlstm.mlstm_init_cache(cfg, batch, s, dtype, device)
    if kind == "slstm":
        return xlstm.slstm_init_cache(cfg, batch, s, dtype, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _block_init(kind: str, gen: torch.Generator, cfg: ModelConfig) -> Params:
    dtype, dev = cfg.param_dtype, gen.device
    p: Params = {"norm1": norm_init(cfg.d_model, cfg.norm, dtype, dev),
                 "mixer": _mixer_init(kind, gen, cfg, dtype)}
    if _has_ff(cfg):
        p["norm2"] = norm_init(cfg.d_model, cfg.norm, dtype, dev)
        if cfg.moe is not None:
            p["moe"] = moe_init(gen, _moe_cfg(cfg), dtype)
        else:
            p["mlp"] = mlp_init(gen, _mlp_cfg(cfg), dtype)
    return p


def _norm_kind(cfg: ModelConfig) -> str:
    if cfg.norm == "rms" and cfg.bf16_reduce:
        return "rms_mp"
    return cfg.norm


def _pin_replicated(y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return clamp_cotangent(y) if cfg.bf16_reduce else y


def _ff(p: Params, x: torch.Tensor, cfg: ModelConfig,
        collect_aux: bool = False):
    """x plus the block's feed-forward of norm2(x), x (B, T, D) or, in
    decode, (B, D): there an MoE routes each sequence's token as a group
    of one at capacity n_experts / top_k (dropless).  With
    ``collect_aux`` also the MoE load-balance loss (None without MoE)."""
    aux = None
    if _has_ff(cfg):
        h = apply_norm(x, p["norm2"], _norm_kind(cfg))
        if cfg.moe is None:
            y = mlp_forward(p["mlp"], h, _mlp_cfg(cfg))
        elif h.dim() == 2:
            mcfg = dataclasses.replace(
                _moe_cfg(cfg),
                capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
            y = moe_forward(p["moe"], h[:, None], mcfg)[:, 0]
        elif collect_aux:
            y, aux = moe_forward(p["moe"], h, _moe_cfg(cfg), return_aux=True)
        else:
            y = moe_forward(p["moe"], h, _moe_cfg(cfg))
        x = x + _pin_replicated(y, cfg)
    return (x, aux) if collect_aux else x


def _block_forward(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                   collect_aux: bool = False):
    y = _mixer_forward(kind, p["mixer"],
                       apply_norm(x, p["norm1"], _norm_kind(cfg)), cfg)
    return _ff(p, x + _pin_replicated(y, cfg), cfg, collect_aux)


def _block_prefill(kind: str, p: Params, x: torch.Tensor, cfg: ModelConfig,
                   cache_len: int):
    y, cache = _mixer_prefill(kind, p["mixer"],
                              apply_norm(x, p["norm1"], cfg.norm), cfg,
                              cache_len)
    return _ff(p, x + y, cfg), cache


def _block_decode(kind: str, p: Params, x: torch.Tensor, cache, pos,
                  cfg: ModelConfig):
    y, cache = _mixer_decode(kind, p["mixer"],
                             apply_norm(x, p["norm1"], cfg.norm), cache, pos,
                             cfg)
    return _ff(p, x + y, cfg), cache


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``seed``, drawn on ``device`` (the CPU when
    None) in the config's dtype; on the meta device shapes and dtypes
    without values (`layers.MetaGenerator`).  ``embed`` for the token modes;
    ``in_proj`` for ``embeds`` where embed_dim_in differs from d_model."""
    gen = generator(seed, device)
    dtype = cfg.param_dtype
    params: Params = {}
    if cfg.input_mode in ("tokens", "tokens+image"):
        params["embed"] = embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                     dtype)
    elif cfg.embed_dim_in and cfg.embed_dim_in != cfg.d_model:
        params["in_proj"] = dense_init(gen, cfg.embed_dim_in, cfg.d_model,
                                       dtype)
    params["layers"] = [_block_init(kind, gen, cfg)
                        for kind in layer_kinds(cfg)]
    params["final_norm"] = norm_init(cfg.d_model, cfg.norm, dtype,
                                     gen.device)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                       dtype)
    return params


def param_device(params: Params) -> torch.device:
    """The device of a param tree (its final norm's)."""
    return params["final_norm"]["w"].device


def embed_batch(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> torch.Tensor:
    """Token / stub-frontend embedding -> (B, S, D)."""
    if cfg.input_mode == "tokens":
        return params["embed"][batch["tokens"].long()]
    if cfg.input_mode == "tokens+image":
        tok = params["embed"][batch["tokens"].long()]       # (B, S_text, D)
        img = batch["patch_embeds"].to(tok.dtype)           # (B, S_img, D)
        return torch.cat([img, tok], dim=1)
    # embeds: precomputed frame / patch features (audio / vision stubs)
    x = batch["embeds"]
    if "in_proj" in params:
        x = x @ params["in_proj"]
    return x.to(cfg.param_dtype)


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def _superblock(kinds, layers, x, cfg: ModelConfig, collect_aux: bool):
    """One period of the pattern: (x, the summed MoE aux or None)."""
    aux = None
    for kind, p in zip(kinds, layers):
        if not collect_aux:
            x = _block_forward(kind, p, x, cfg)
            continue
        x, a = _block_forward(kind, p, x, cfg, collect_aux=True)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def forward(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, return_aux: bool = False):
    """Logits (B, S, padded_vocab) of every position (and, with
    ``return_aux``, the MoE load-balance loss summed over the layers,
    float32, 0 without MoE, collected in the same pass)."""
    x = embed_batch(params, batch, cfg)
    kinds, n = layer_kinds(cfg), len(cfg.pattern)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for i in range(0, len(kinds), n):
        args = (kinds[i:i + n], params["layers"][i:i + n], x, cfg,
                return_aux)
        x, a = (checkpoint(_superblock, *args, use_reentrant=False)
                if remat else _superblock(*args))
        if a is not None:
            aux = a if aux is None else aux + a
    logits = unembed(params, apply_norm(x, params["final_norm"], cfg.norm),
                     cfg)
    if not return_aux:
        return logits
    return logits, (torch.zeros((), dtype=torch.float32, device=x.device)
                    if aux is None else aux)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Cross-entropy next-token / masked-prediction loss over the real
    vocabulary (the padding columns dropped), the text positions only in
    the ``tokens+image`` mode, weighted by ``loss_mask`` where the batch
    has one; plus ``aux_weight`` times the MoE load-balance loss.
    Returns (loss, {"ce_loss", ["moe_aux",] "loss"})."""
    if cfg.moe is not None:
        logits, aux = forward(params, batch, cfg, return_aux=True)
    else:
        logits = forward(params, batch, cfg)
    if cfg.input_mode == "tokens+image":
        logits = logits[:, cfg.n_image_tokens:]
    logp = F.log_softmax(logits[..., :cfg.vocab].float(), dim=-1)
    ll = torch.gather(logp, -1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    loss = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    metrics = {"ce_loss": loss}
    if cfg.moe is not None:
        metrics["moe_aux"] = aux
        loss = loss + aux_weight * aux
    metrics["loss"] = loss
    return loss, metrics


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """One zero cache per layer: attention k/v (B, Hkv, S, Dh) with S =
    ``kv_cache_len(cache_len)``; recurrent h (B, W) float32 and conv
    state (B, K-1, W); mLSTM C, n, m and sLSTM c, n, h, m (float32, m at
    -1e30)."""
    dtype, s = cfg.param_dtype, cfg.kv_cache_len(cache_len)
    return [_mixer_init_cache(kind, cfg, batch, s, dtype, device)
            for kind in layer_kinds(cfg)]


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            cache_len: int) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Run the prompt (image tokens first in the ``tokens+image`` mode):
    the last position's logits (B, 1, padded_vocab) and the caches."""
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
    """tokens (B,) (in the ``embeds`` mode the rows (B, D) themselves),
    pos (B,) absolute positions -> logits (B, padded_vocab) and the caches
    after the step (attention caches are updated in place, the others
    replaced)."""
    x = tokens if cfg.input_mode == "embeds" \
        else params["embed"][tokens.long()]
    new_caches = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], caches):
        x, c = _block_decode(kind, p, x, c, pos, cfg)
        new_caches.append(c)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return unembed(params, x, cfg), new_caches


def param_count(params: Params) -> int:
    return sum(t.numel() for t in tree_lib.leaves(params))
