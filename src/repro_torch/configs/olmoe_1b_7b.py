"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf].

16L d_model=2048 16H (MHA kv=16) expert d_ff=1024 vocab=50304.
ViTA mapping: fused MLP applies per-expert; expert-parallel over `model`
(64 experts / 16 = 4 per device)."""

from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=50304,
    moe=MoESpec(n_experts=64, top_k=8, d_ff=1024),
    activation="silu", gated=True, norm="rms",
    subquadratic=False,
)
