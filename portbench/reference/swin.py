"""Swin as the program serves it, in plain PyTorch (a frozen copy of the
math of the program's `models/swin.py::reference_forward`, written
directly: window partition, cyclic shift, shifted-window mask, relative
position bias, patch merging).

Departures from the published Swin-T (Liu et al., arXiv:2103.14030),
which the program shares and this reference keeps:

* no bias on the Q/K/V projections, the attention output projection, the
  patch embedding or the head;
* GELU in its tanh approximation;
* the shifted-window mask adds -1e30 (the published code adds -100).

Shifted windows: blocks 1, 3, ... of a stage shift by window // 2, except
in a stage that is a single window.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from . import common


def leaves(cfg: Mapping[str, Any]) -> List:
    c, p, win = cfg["embed_dim"], cfg["patch"], cfg["window"]
    out = [(("patch_embed",), (p * p * 3, c), "matrix", 0.0),
           (("pe_ln_w",), (c,), "ln_scale", 0.0),
           (("pe_ln_b",), (c,), "shift", 0.1)]
    dim, n_stages = c, len(cfg["depths"])
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        hidden = int(dim * cfg["mlp_ratio"])
        for b in range(depth):
            prefix = ("stages", s, "blocks", b)
            out += common.block_leaves(prefix, dim, heads, hidden)
            out.append((prefix + ("rel_bias",),
                        ((2 * win - 1) ** 2, heads), "table", 1.0))
        if s < n_stages - 1:
            out += [(("stages", s, "merge_ln_w"), (4 * dim,), "ln_scale", 0.0),
                    (("stages", s, "merge_ln_b"), (4 * dim,), "shift", 0.1),
                    (("stages", s, "merge_w"), (4 * dim, 2 * dim), "matrix",
                     0.0)]
            dim *= 2
    out += [(("ln_f_w",), (dim,), "ln_scale", 0.0),
            (("ln_f_b",), (dim,), "shift", 0.1),
            (("head",), (dim, cfg["n_classes"]), "matrix", 0.0)]
    return out


@functools.lru_cache(maxsize=None)
def rel_index(win: int) -> np.ndarray:
    """(n, n) index into the (2 win - 1)^2 relative-position table."""
    ys, xs = np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    coords = np.stack([ys.ravel(), xs.ravel()])             # (2, n)
    rel = coords[:, :, None] - coords[:, None, :] + (win - 1)
    return (rel[0] * (2 * win - 1) + rel[1]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_mask(side: int, win: int, shift: int) -> np.ndarray:
    """(nW, n, n) additive mask of the shifted windows: a token attends only
    to tokens of its own region of the rolled grid."""
    region = np.zeros((side, side), np.int64)
    bands = (slice(0, side - win), slice(side - win, side - shift),
             slice(side - shift, side))
    label = 0
    for hs in bands:
        for ws in bands:
            region[hs, ws] = label
            label += 1
    regw = region.reshape(side // win, win, side // win, win)
    regw = regw.transpose(0, 2, 1, 3).reshape(-1, win * win)
    same = regw[:, :, None] == regw[:, None, :]
    return np.where(same, 0.0, common.NEG_INF).astype(np.float32)


def _windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, S, S, C) -> (B * nW, win * win, C), windows in raster order."""
    b, s, _, c = x.shape
    x = x.reshape(b, s // win, win, s // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def _unwindows(xw: torch.Tensor, win: int, s: int) -> torch.Tensor:
    b = xw.shape[0] // ((s // win) ** 2)
    x = xw.reshape(b, s // win, s // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, s, s, -1)


def _window_attention(bp: Dict[str, Any], z: torch.Tensor, win: int,
                      shift: int, mode: str) -> torch.Tensor:
    """Windowed (shifted) multi-head attention of z (B, S, S, C), with the
    output projection."""
    b, s, _, _ = z.shape
    dev = z.device
    if shift:
        z = torch.roll(z, (-shift, -shift), dims=(1, 2))
    idx = torch.from_numpy(rel_index(win)).to(dev)
    extra = bp["rel_bias"][idx].permute(2, 0, 1)[None]     # (1, H, n, n)
    if shift:
        mask = torch.from_numpy(shift_mask(s, win, shift)).to(dev)
        extra = extra + mask.repeat(b, 1, 1)[:, None]       # (B*nW, H, n, n)
    o = common.attention(_windows(z, win), bp["wq"], bp["wk"], bp["wv"],
                         mode, extra)
    o = _unwindows(common.mm(o, bp["w_msa"], mode), win, s)
    if shift:
        o = torch.roll(o, (shift, shift), dims=(1, 2))
    return o


def forward(params: Dict[str, Any], images: torch.Tensor,
            cfg: Mapping[str, Any], mode: str = "fp32") -> torch.Tensor:
    """(B, H, W, 3) float32 images -> (B, n_classes) logits at ``mode``."""
    mm, win = common.mm, cfg["window"]
    b = images.shape[0]
    side = cfg["image"] // cfg["patch"]
    with common.precision(mode):
        x = mm(common.extract_patches(images, cfg["patch"]),
               params["patch_embed"], mode)
        x = common.layer_norm(x, params["pe_ln_w"], params["pe_ln_b"])
        x = x.reshape(b, side, side, -1)
        for stage in params["stages"]:
            s = x.shape[1]
            for i, bp in enumerate(stage["blocks"]):
                shift = win // 2 if i % 2 == 1 and s > win else 0
                z = common.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
                x = x + _window_attention(bp, z, win, shift, mode)
                z = common.layer_norm(x, bp["ln2_w"], bp["ln2_b"])
                hid = common.gelu_tanh(mm(z, bp["w_up"], mode) + bp["b_up"])
                x = x + mm(hid, bp["w_down"], mode) + bp["b_down"]
            if "merge_w" in stage:
                c = x.shape[-1]
                x = x.reshape(b, s // 2, 2, s // 2, 2, c)
                x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, s // 2, s // 2,
                                                        4 * c)
                x = common.layer_norm(x, stage["merge_ln_w"],
                                      stage["merge_ln_b"])
                x = mm(x, stage["merge_w"], mode)
        x = common.layer_norm(x, params["ln_f_w"], params["ln_f_b"])
        return mm(x.mean(dim=(1, 2)), params["head"], mode)
