"""StableLM-3B — dense MHA [hf:stabilityai/stablelm-*; unverified].

32L d_model=2560 32H (kv=32, i.e. MHA) d_ff=6912 vocab=50304.
head_dim = 80 (not a multiple of 32: the attention kernels mask the
ragged lanes)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    activation="silu", gated=True, norm="ln",
    subquadratic=False,
)
