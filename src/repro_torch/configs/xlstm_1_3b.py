"""xLSTM-1.3B — sLSTM + mLSTM blocks, ratio 1:7 [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 (the mLSTM block carries its own 2x up/down
projection) vocab=50304.  Attention-free: decode state is O(1) per layer,
so long_500k runs.  The ViTA head-attention technique is inapplicable
(DESIGN.md §Arch-applicability); the block projections use the fused-MLP
treatment."""

from repro_torch.models.config import ModelConfig

_PATTERN = ("slstm",) + ("mlstm",) * 7     # xLSTM[7:1], 6 superblocks

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    pattern=_PATTERN,
    rope_theta=None,
    norm="ln",
    subquadratic=True,
)
