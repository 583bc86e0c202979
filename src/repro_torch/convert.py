"""Weight bridge: parameter trees and calibration scales from numpy.

`params_from_numpy` takes a parameter tree whose leaves are array-likes
(numpy arrays, or any object `numpy.asarray` accepts) and returns the
port's tree of tensors on ``device``.  A leaf with ``.values`` and
``.scale`` (a quantized tensor of any framework) becomes the port's
`QTensor`.  `calibrator_from_scales` turns a frozen ``{site: scale}`` map
into a frozen port `Calibrator`.  Nothing here imports the framework the
arrays came from.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.quant import Calibrator, QTensor


def _tensor(leaf: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


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
