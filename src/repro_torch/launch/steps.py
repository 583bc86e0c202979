"""Step functions (counterpart of `repro/launch/steps.py`): the train
step, prefill, decode and forward, and the analytic FLOP model.

Each factory closes over the config and returns a plain function; PyTorch
runs eagerly, so there is no jit.  A batch is the model's input dict:
``tokens``; ``tokens`` and ``patch_embeds`` (``tokens+image``, the image
ahead of the text; decoding goes on at `next_position`); or ``embeds``
(HuBERT's frames, which `make_forward_step` serves: it has no decode);
a training batch adds ``labels`` (and optionally ``loss_mask``).  With
``with_logits`` the prefill and decode steps also return the logits they
chose from (the server keeps them to compare devices).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               constant_lr, ef_compress_grads, ef_init)


def loss_and_grads(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, metrics, grads) of `transformer.loss_fn` at ``params``:
    the grads a tree like ``params``, each in its leaf's dtype (zeros
    where the loss does not reach a leaf, as JAX's).  ``params`` are not
    modified: the loss runs on detached leaves that require grad."""
    flat = tree_lib.leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    with torch.enable_grad():
        loss, metrics = tr.loss_fn(tree_lib.unflatten(params, live), batch,
                                   cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_lib.unflatten(params, grads))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: AdamWConfig = AdamWConfig(),
                    lr_fn: Optional[Callable] = None,
                    grad_compression: bool = False) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics),
    the metrics ``loss``, ``ce_loss``, ``moe_aux`` (MoE only),
    ``grad_norm`` and ``lr`` (0-d tensors).

    With ``grad_compression`` the gradients pass through int8
    error-feedback compression (opt_state carries the residuals),
    modelling the compressed cross-pod all-reduce.  New trees are
    returned; the caller's are not modified.
    """
    lr_fn = lr_fn or constant_lr(3e-4)

    def step_fn(params, opt_state, batch, step):
        _, metrics, grads = loss_and_grads(params, batch, cfg)
        lr = lr_fn(step)
        new_params, new_state, opt_metrics = apply_grads(
            grads, params, opt_state, lr, opt_cfg, grad_compression,
            len(cfg.pattern))
        return new_params, new_state, dict(metrics, **opt_metrics, lr=lr)

    return step_fn


def apply_grads(grads: Any, params: Any, opt_state: Dict[str, Any], lr,
                opt_cfg: AdamWConfig = AdamWConfig(),
                grad_compression: bool = False, pattern_len: int = 1
                ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """The train step after the gradients: the int8 error-feedback
    compression (with ``grad_compression``; the config's ``pattern_len``
    groups the layers as the JAX package stacks them,
    `optim.compress.stack_key`), then AdamW at ``lr``.
    (new params, new opt_state, {"grad_norm"})."""
    if grad_compression:
        grads, new_resid = ef_compress_grads(
            grads, opt_state["ef_residuals"], pattern_len)
    new_params, new_adam, opt_metrics = adamw_update(
        grads, opt_state["adam"], params, lr, opt_cfg)
    new_state = {"adam": new_adam}
    if grad_compression:
        new_state["ef_residuals"] = new_resid
    return new_params, new_state, opt_metrics


def init_opt_state(params: Any, grad_compression: bool = False
                   ) -> Dict[str, Any]:
    state = {"adam": adamw_init(params)}
    if grad_compression:
        state["ef_residuals"] = ef_init(params)
    return state


def next_position(cfg: ModelConfig, batch) -> int:
    """The absolute position of the first decoded token after a prefill
    of ``batch``: the prompt's length, the image tokens included in the
    ``tokens+image`` mode (they come first, and the caches cover them)."""
    if cfg.input_mode == "embeds":
        return batch["embeds"].shape[1]
    n = batch["tokens"].shape[1]
    return n + cfg.n_image_tokens if cfg.input_mode == "tokens+image" else n


def greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """argmax over the real vocabulary (the padding columns never win),
    int32."""
    return torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      with_logits: bool = False) -> Callable:
    """(params, batch) -> (next_token (B,), caches[, logits (B, V)])."""

    def prefill_fn(params, batch):
        logits, caches = tr.prefill(params, batch, cfg, cache_len)
        tok = greedy(logits, cfg)[:, 0]
        return (tok, caches, logits[:, 0]) if with_logits else (tok, caches)

    return prefill_fn


def make_decode_step(cfg: ModelConfig, sample: str = "greedy", *,
                     with_logits: bool = False) -> Callable:
    """(params, tokens (B,), caches, pos (B,)) -> (next tokens, caches[,
    logits])."""
    if sample != "greedy":
        raise NotImplementedError(f"sampling {sample!r}: only greedy")

    def decode_fn(params, tokens, caches, pos):
        logits, caches = tr.decode_step(params, tokens, caches, pos, cfg)
        tok = greedy(logits, cfg)
        return (tok, caches, logits) if with_logits else (tok, caches)

    return decode_fn


def make_forward_step(cfg: ModelConfig) -> Callable:
    """Encoder / no-cache inference forward: (params, batch) -> logits."""

    def forward_fn(params, batch):
        return tr.forward(params, batch, cfg)

    return forward_fn


# ---------------------------------------------------------------------------
# Analytic FLOP model (MODEL_FLOPS = 6*N_active per trained token,
# 2*N_active per inferred one), the JAX package's count
# ---------------------------------------------------------------------------


def active_param_count(cfg: ModelConfig, params: Any) -> Tuple[int, int]:
    """(total params, active-per-token params).  MoE: the router and
    top_k of the experts of each layer count as active; the embedding and
    unembedding are left out of the FLOPs (matmul params only)."""
    total = active = 0
    for path, leaf in tree_lib.leaves_with_path(params):
        keys = [str(k) for k in path]
        n = leaf.numel()
        total += n
        if "embed" in keys[-1] or "unembed" in keys[-1]:
            continue
        if "moe" in keys and keys[-1] in ("w_up", "w_gate", "w_down"):
            active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    return total, active


def model_flops(cfg: ModelConfig, params: Any, cell_kind: str,
                tokens: int) -> float:
    """Useful FLOPs of a cell: 6*N_active*tokens to train,
    2*N_active*tokens to infer."""
    _, active = active_param_count(cfg, params)
    per_tok = 6.0 * active if cell_kind == "train" else 2.0 * active
    return per_tok * tokens
