"""ViT / DeiT as the program serves it, in plain PyTorch (a frozen copy of
the math of the program's `models/vit.py` schedule, written directly).

Departures from the published DeiT (Touvron et al., arXiv:2012.12877),
which the program shares and this reference keeps:

* no class token and no distillation token: the 196 patch tokens are
  mean-pooled after the final LayerNorm (ViTA's layout);
* no bias on the Q/K/V projections, the attention output projection, the
  patch embedding or the head;
* GELU in its tanh approximation;
* a positional embedding of 196 rows.

`leaves` lists the parameters in the program's tree layout (per-head
wq/wk/wv (H, D, Dh)), which `common.make_tree` draws from a seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from . import common


def leaves(cfg: Mapping[str, Any]) -> List:
    d, p = cfg["dim"], cfg["patch"]
    tokens = (cfg["image"] // p) ** 2
    hidden = int(d * cfg["mlp_ratio"])
    out = [(("patch_embed",), (p * p * 3, d), "matrix", 0.0),
           (("pos_embed",), (tokens, d), "table", 0.1)]
    for i in range(cfg["layers"]):
        out += common.block_leaves(("layers", i), d, cfg["heads"], hidden)
    out += [(("ln_f_w",), (d,), "ln_scale", 0.0),
            (("ln_f_b",), (d,), "shift", 0.1),
            (("head",), (d, cfg["n_classes"]), "matrix", 0.0)]
    return out


def forward(params: Dict[str, Any], images: torch.Tensor,
            cfg: Mapping[str, Any], mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) float32 images -> (B, n_classes) logits at ``mode``."""
    mm = common.mm
    with common.precision(mode):
        x = mm(common.extract_patches(images, cfg["patch"]),
               params["patch_embed"], mode) + params["pos_embed"]
        for lp in params["layers"]:
            z = common.layer_norm(x, lp["ln1_w"], lp["ln1_b"])
            sa = common.attention(z, lp["wq"], lp["wk"], lp["wv"], mode)
            x = x + mm(sa, lp["w_msa"], mode)
            z = common.layer_norm(x, lp["ln2_w"], lp["ln2_b"])
            hid = common.gelu_tanh(mm(z, lp["w_up"], mode) + lp["b_up"])
            x = x + mm(hid, lp["w_down"], mode) + lp["b_down"]
        x = common.layer_norm(x, params["ln_f_w"], params["ln_f_b"])
        return mm(x.mean(dim=1), params["head"], mode)
