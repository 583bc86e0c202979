"""TNT as the program serves it, in plain PyTorch, importing nothing of
the program: every layer runs an inner transformer over each patch's
pixel tokens, folds them into the outer stream, then runs the outer
block.  It follows the program's math, departures included, so the
benchmark's tests also hold its layout to the paper's own definition
(the raster order of patches and pixel tokens).

Departures from the published TNT-S (Han et al., "Transformer in
Transformer", arXiv:2103.00112, and its released code), which the program
shares and this reference keeps:

* no class token: the 196 patch tokens are mean-pooled after the final
  LayerNorm, and the outer positional embedding has 196 rows (published:
  197, the class token classified);
* the pixel embedding is a linear map of each 4 x 4 x 3 sub-patch, with
  no bias (published: a 7 x 7 convolution of stride 4 and padding 3 over
  each 16 x 16 patch, with a bias);
* the outer patch embedding is LayerNorm over each patch's 16 x 24
  flattened pixel tokens, then a 384 x 384 linear map with no bias
  (published: the same, with a bias, then a second LayerNorm);
* no bias on the Q/K/V projections (as published) nor on the attention
  output projection, in both blocks, nor on the head;
* GELU in its tanh approximation.

The fold of every layer (LayerNorm over the flattened pixel tokens, then
a 384 x 384 linear map with a bias, added to the outer stream) is as
published.

`leaves` lists the parameters in the program's tree layout (per-head
wq/wk/wv (H, D, Dh) in both blocks, nested as each layer's ``inner`` and
``outer``), which `common.make_tree` draws from a seed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from . import common


def leaves(cfg: Mapping[str, Any]) -> List:
    d, c, p, ip = cfg["dim"], cfg["inner_dim"], cfg["patch"], \
        cfg["inner_patch"]
    tokens = (cfg["image"] // p) ** 2
    m = (p // ip) ** 2                          # pixel tokens a patch
    flat = m * c
    out = [(("pixel_embed",), (ip * ip * 3, c), "matrix", 0.0),
           (("inner_pos_embed",), (m, c), "table", 0.1),
           (("pe_ln_w",), (flat,), "ln_scale", 0.0),
           (("pe_ln_b",), (flat,), "shift", 0.1),
           (("patch_embed",), (flat, d), "matrix", 0.0),
           (("pos_embed",), (tokens, d), "table", 0.1)]
    for i in range(cfg["layers"]):
        out += common.block_leaves(("layers", i, "inner"), c,
                                   cfg["inner_heads"],
                                   int(c * cfg["inner_mlp_ratio"]))
        out += [(("layers", i, "fold_ln_w"), (flat,), "ln_scale", 0.0),
                (("layers", i, "fold_ln_b"), (flat,), "shift", 0.1),
                (("layers", i, "fold_w"), (flat, d), "matrix", 0.0),
                (("layers", i, "fold_b"), (d,), "shift", 0.1)]
        out += common.block_leaves(("layers", i, "outer"), d, cfg["heads"],
                                   int(d * cfg["mlp_ratio"]))
    out += [(("ln_f_w",), (d,), "ln_scale", 0.0),
            (("ln_f_b",), (d,), "shift", 0.1),
            (("head",), (d, cfg["n_classes"]), "matrix", 0.0)]
    return out


def pixel_tokens(images: torch.Tensor, patch: int, inner_patch: int
                 ) -> torch.Tensor:
    """(B, H, W, 3) -> (B * N, m, ip * ip * 3): each patch's sub-patches,
    patches in raster order folded into the batch axis, sub-patches in
    raster order within their patch, each flattened in (row, column,
    channel) order."""
    b, h, w, ch = images.shape
    s = patch // inner_patch
    x = images.reshape(b, h // patch, s, inner_patch, w // patch, s,
                       inner_patch, ch)
    # (image, patch row, patch col, sub row, sub col, row, col, channel)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b * (h // patch) * (w // patch), s * s,
                     inner_patch * inner_patch * ch)


def _block(bp: Dict[str, Any], x: torch.Tensor, mode: str) -> torch.Tensor:
    """Pre-LN encoder block: MSA and MLP, each with its residual."""
    mm = common.mm
    z = common.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    sa = common.attention(z, bp["wq"], bp["wk"], bp["wv"], mode)
    x = x + mm(sa, bp["w_msa"], mode)
    z = common.layer_norm(x, bp["ln2_w"], bp["ln2_b"])
    hid = common.gelu_tanh(mm(z, bp["w_up"], mode) + bp["b_up"])
    return x + mm(hid, bp["w_down"], mode) + bp["b_down"]


def forward(params: Dict[str, Any], images: torch.Tensor,
            cfg: Mapping[str, Any], mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) float32 images -> (B, n_classes) logits at ``mode``."""
    mm = common.mm
    b = images.shape[0]
    n = (cfg["image"] // cfg["patch"]) ** 2
    with common.precision(mode):
        y = mm(pixel_tokens(images, cfg["patch"], cfg["inner_patch"]),
               params["pixel_embed"], mode) + params["inner_pos_embed"]
        flat = common.layer_norm(y.reshape(b, n, -1), params["pe_ln_w"],
                                 params["pe_ln_b"])
        x = mm(flat, params["patch_embed"], mode) + params["pos_embed"]
        for lp in params["layers"]:
            y = _block(lp["inner"], y, mode)
            flat = common.layer_norm(y.reshape(b, n, -1), lp["fold_ln_w"],
                                     lp["fold_ln_b"])
            x = x + mm(flat, lp["fold_w"], mode) + lp["fold_b"]
            x = _block(lp["outer"], x, mode)
        x = common.layer_norm(x, params["ln_f_w"], params["ln_f_b"])
        return mm(x.mean(dim=1), params["head"], mode)
