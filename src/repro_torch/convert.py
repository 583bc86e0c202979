"""Weight bridge: parameter trees and calibration scales from numpy.

`params_from_numpy` takes a parameter tree whose leaves are array-likes
(numpy arrays, or any object `numpy.asarray` accepts) and returns the
port's tree of tensors on ``device``.  A leaf with ``.values`` and
``.scale`` (a quantized tensor of any framework) becomes the port's
`QTensor`.  `calibrator_from_scales` turns a frozen ``{site: scale}`` map
into a frozen port `Calibrator`.  `lm_params_from_numpy` and
`lm_caches_from_numpy` turn the JAX LM layout (one tree per pattern
position, stacked over the superblocks) into the port's flat per-layer
lists, and `lm_opt_state_from_numpy` the train step's optimizer state
with them (JAX gradients carry over with `lm_params_from_numpy`).  Nothing here imports the framework the arrays came from.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.quant import Calibrator, QTensor


def _tensor(leaf: Any, device) -> torch.Tensor:
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":          # numpy's bfloat16 extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "values") and hasattr(tree, "scale"):
        return QTensor(_tensor(tree.values, device),
                       _tensor(tree.scale, device))
    return _tensor(tree, device)


def calibrator_from_scales(scales: Mapping[str, Any],
                           device="cpu") -> Calibrator:
    """A frozen `Calibrator` whose per-site scales are ``scales``
    (float32), amax = scale * 127 for the record."""
    cal = Calibrator()
    cal.frozen = {k: torch.tensor(np.float32(np.asarray(v)),
                                  dtype=torch.float32, device=device)
                  for k, v in scales.items()}
    cal.amax = {k: float(v) * 127.0 for k, v in cal.frozen.items()}
    return cal


def _take(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i].contiguous()


def _unstack_layers(stacked: Any, device) -> list:
    """A tuple of P trees stacked over n superblocks -> the n * P layer
    trees in order (layer i = position i % P of superblock i // P)."""
    per_pos = [params_from_numpy(t, device) for t in stacked]

    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, dict) \
            else t
    n = first_leaf(per_pos[0]).shape[0]
    return [_take(per_pos[pos], sb) for sb in range(n)
            for pos in range(len(per_pos))]


def lm_params_from_numpy(tree: Mapping[str, Any], device="cpu") -> dict:
    """The JAX LM parameter tree (leaves array-likes; ``layers`` a tuple
    with one stacked tree per pattern position, leading axis
    n_superblocks) -> the port's tree, ``layers`` a flat per-layer list.
    Every leaf keeps its dtype and its shape past the stacking axis: an
    MoE layer's float32 ``router`` and (E, D, F) expert stacks, xLSTM's
    (H, dh, dh) block-diagonal weights and float32 ``r`` / ``b_if`` /
    ``b_in``; ``embed``, ``in_proj`` and the rest of the top level as they
    are."""
    out = {k: params_from_numpy(v, device) for k, v in tree.items()
           if k != "layers"}
    out["layers"] = _unstack_layers(tree["layers"], device)
    return out


def lm_caches_from_numpy(caches: Any, device="cpu") -> list:
    """The JAX LM caches (a tuple of stacked per-position cache trees:
    attention k/v, RG-LRU, mLSTM C/n/m, sLSTM c/n/h/m) -> the port's
    per-layer cache list."""
    return _unstack_layers(caches, device)


def lm_opt_state_from_numpy(state: Mapping[str, Any], device="cpu") -> dict:
    """The JAX train step's optimizer state ``{"adam": {"m", "v",
    "count"}[, "ef_residuals"]}`` -> the port's: the moment and residual
    trees unstacked as `lm_params_from_numpy` unstacks the params (so
    they line up leaf for leaf), ``count`` an int32 0-d tensor on the
    host (`optim.adamw`)."""
    adam = state["adam"]
    out = {"adam": {"m": lm_params_from_numpy(adam["m"], device),
                    "v": lm_params_from_numpy(adam["v"], device),
                    "count": torch.tensor(int(np.asarray(adam["count"])),
                                          dtype=torch.int32)}}
    if "ef_residuals" in state:
        out["ef_residuals"] = lm_params_from_numpy(state["ef_residuals"],
                                                   device)
    return out
