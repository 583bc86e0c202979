"""H2O-Danube-1.8B — llama+mistral mix with SWA [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, window 4096."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    window=4096,
    activation="silu", gated=True, norm="rms",
    subquadratic=True,
)
