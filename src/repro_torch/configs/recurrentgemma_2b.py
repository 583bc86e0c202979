"""RecurrentGemma-2B — RG-LRU + local attention, 2:1 [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
local-attention window 2048.  Griffin layout: attention at layers
2,5,8,...,23 (8 attn / 18 recurrent over 26 layers).  26 isn't divisible by
3, so the scan uses a 13-block superpattern x 2 that reproduces the exact
layer sequence.  long_500k runs: RG-LRU state is O(1), attention cache is
ring-bounded at the window."""

from repro_torch.models.config import ModelConfig

# (rec,rec,attn) x 4 + rec == layers 0..12; two superblocks = 26 layers
_PATTERN = ("rec", "rec", "attn") * 4 + ("rec",)

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    pattern=_PATTERN,
    window=2048, lru_width=2560, conv_width=4,
    activation="gelu", gated=True, norm="rms",
    subquadratic=True,
)
