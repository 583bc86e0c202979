"""Nemotron-4-15B — dense GQA with squared-ReLU MLP [arXiv:2402.16819].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.  Ungated MLP with
act = relu(x)^2; LayerNorm."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000,
    activation="relu2", gated=False, norm="ln",
    rope_theta=10000.0,
    subquadratic=False,
)
