"""Optimizer, learning-rate schedules and gradient compression
(counterpart of `repro/optim`)."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, decay_mask, decays,
                    decays_by_own_rank)
from .schedules import constant_lr, cosine_schedule, linear_warmup_cosine
from .compress import (CompressionState, compress_int8, decompress_int8,
                       ef_compress_grads, ef_init, stack_key)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
    "decay_mask", "decays", "decays_by_own_rank", "cosine_schedule", "constant_lr", "linear_warmup_cosine",
    "CompressionState", "compress_int8", "decompress_int8",
    "ef_compress_grads", "ef_init", "stack_key",
]
