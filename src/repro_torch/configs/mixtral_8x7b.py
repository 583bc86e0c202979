"""Mixtral-8x7B — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, window 4096.
8 experts don't divide the 16-way model axis -> TP *inside* each expert
(d_ff 14336/16); EP is demonstrated on olmoe.  SWA makes long_500k decode
run with a ring cache bounded at the window."""

from repro_torch.models.config import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab=32000,
    moe=MoESpec(n_experts=8, top_k=2, d_ff=14336),
    window=4096,
    activation="silu", gated=True, norm="rms",
    subquadratic=True,
)
