"""Inference step functions (counterpart of the serving half of
`repro/launch/steps.py`): prefill, decode and forward.

Each factory closes over the config and returns a plain function; PyTorch
runs eagerly, so there is no jit.  A batch is the model's input dict:
``tokens``; ``tokens`` and ``patch_embeds`` (``tokens+image``, the image
ahead of the text; decoding goes on at `next_position`); or ``embeds``
(HuBERT's frames, which `make_forward_step` serves: it has no decode).
With ``with_logits`` the prefill and decode steps also return the logits
they chose from (the server keeps them to compare devices).  The train
step comes with the training port.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as tr
from repro_torch.models.config import ModelConfig


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
