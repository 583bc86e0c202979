"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (masked-unit
prediction targets).  The conv waveform frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, T, 1280) that already carry
temporal structure (hence rope_theta=None).  Encoder-only: no decode
shapes (noted in DESIGN.md)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504,
    causal=False, rope_theta=None,
    input_mode="embeds",
    activation="gelu", gated=False, norm="ln",
    supports_decode=False, subquadratic=False,
)
