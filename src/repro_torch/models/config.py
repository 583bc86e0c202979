"""Model configuration (counterpart of `repro/models/config.py`): the
LM `ModelConfig` shared by every architecture in `repro_torch.configs`,
and the vision head masks.

The JAX module imports `jax.numpy`, so the port keeps its own copy;
`param_dtype` is a `torch.dtype`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Every field of the JAX `ModelConfig`, in its order.  The sharding
    and dry-run knobs (``seq_shard``, ``fsdp``, ``moe_ep_virtual``,
    ``attn_dp``, ``block_barrier``, ``unroll``, ``backend``) are kept so
    a config reads the same in both packages; the port reads
    ``moe_ep_virtual`` (the MoE's virtual experts), ``bf16_reduce`` (the
    ``rms_mp`` norm and cotangent clamps) and ``remat`` (recompute each
    superblock in the backward), the others not."""

    name: str
    family: str                     # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- block structure ---
    pattern: Tuple[str, ...] = ("attn",)   # kinds: attn | rec | mlstm | slstm
    moe: Optional[MoESpec] = None          # replaces dense MLP when set
    # --- attention options ---
    window: Optional[int] = None           # SWA size (None = full attention)
    qkv_bias: bool = False
    causal: bool = True                    # False = encoder-only (hubert)
    rope_theta: Optional[float] = 10000.0
    # --- mlp options ---
    activation: str = "silu"
    gated: bool = True
    mlp_bias: bool = False
    # --- recurrent (RG-LRU) options ---
    lru_width: Optional[int] = None
    conv_width: int = 4
    # --- embedding/IO ---
    input_mode: str = "tokens"             # tokens | embeds | tokens+image
    n_image_tokens: int = 0                # for input_mode=tokens+image
    embed_dim_in: Optional[int] = None     # for input_mode=embeds stubs
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    norm: str = "rms"                      # rms | ln
    # --- numerics / execution ---
    dtype: str = "bfloat16"
    backend: Optional[str] = None
    remat: bool = False
    unroll: bool = False
    # --- sharding knobs of the JAX package ---
    seq_shard: bool = False
    fsdp: bool = False
    moe_ep_virtual: int = 1
    attn_dp: bool = False
    block_barrier: bool = False
    bf16_reduce: bool = False
    # --- shape-cell support metadata ---
    supports_decode: bool = True
    subquadratic: bool = False             # can run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def param_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers are not "
                             f"a whole number of {self.pattern} periods")
        return self.n_layers // len(self.pattern)

    def kv_cache_len(self, seq_len: int) -> int:
        """Per-layer KV length: SWA bounds the cache by the window."""
        if self.window is not None:
            return min(seq_len, self.window)
        return seq_len

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the JAX
        package's `reduced`, field for field)."""
        small = dict(
            n_layers=len(self.pattern) * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // self.n_heads),
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            window=min(self.window, 32) if self.window else None,
            lru_width=64 if self.lru_width else None,
            moe=MoESpec(n_experts=8, top_k=min(self.moe.top_k, 2), d_ff=32,
                        capacity_factor=4.0)
            if self.moe else None,
            n_image_tokens=8 if self.n_image_tokens else 0,
            dtype="float32",
            vocab_pad_multiple=16,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Vision head masks
# ---------------------------------------------------------------------------


def normalize_head_mask(mask, *, layers: int, heads: int):
    """Canonicalize ``mask`` to a ``layers x heads`` tuple of 0/1 tuples.

    Accepts ``None`` (dense — returned unchanged), one flat per-head mask
    of length ``heads`` (broadcast to every layer), or a per-layer
    sequence of per-head masks.  Every layer must keep at least one head;
    lengths must match exactly (a mask outliving a config change is a
    deployment bug, not a broadcast opportunity).
    """
    if mask is None:
        return None
    rows = list(mask)
    if rows and not hasattr(rows[0], "__len__"):
        rows = [rows] * layers                       # flat mask: all layers
    if len(rows) != layers:
        raise ValueError(
            f"head mask has {len(rows)} layer rows, config has {layers}")
    out = []
    for li, row in enumerate(rows):
        row = tuple(int(bool(v)) for v in row)
        if len(row) != heads:
            raise ValueError(
                f"head mask layer {li} has {len(row)} entries, config "
                f"has {heads} heads")
        if not any(row):
            raise ValueError(f"head mask layer {li} keeps no heads")
        out.append(row)
    return tuple(out)


def surviving_heads(mask_row) -> tuple:
    """Indices of the heads a per-layer mask row keeps, in order."""
    return tuple(i for i, v in enumerate(mask_row) if v)
