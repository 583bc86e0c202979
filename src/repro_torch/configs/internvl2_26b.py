"""InternVL2-26B — InternViT frontend + InternLM2 LM [arXiv:2404.16821; hf].

Backbone only (per the assignment): 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553.  The vision frontend is a STUB: input_specs()
provides precomputed patch embeddings (B, 1024, d_model) concatenated ahead
of the text tokens.  Closest assigned arch to the paper's own ViT domain."""

from repro_torch.models.config import ModelConfig

N_IMAGE_TOKENS = 1024

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553,
    input_mode="tokens+image", n_image_tokens=N_IMAGE_TOKENS,
    activation="silu", gated=True, norm="rms",
    subquadratic=False,
)
