"""Faults planted underneath the program's serving path, and the control,
so that the check can be shown to fail a broken timed path.

One per fault a vision cell can have, and the control:

* ``state_unchanged``: every encoder layer (kernel 1,
  ``ops.vita_layer_fused``) returns its input;
* ``half_batch``: half of each micro-batch left out, its rows copied from
  the other half;
* ``answer_altered``: one logit of the last answer served moved by a
  thousandth of its scale where the server hands it out;
* ``control_tf32``: the plain reference, computed with TF32 products,
  put in the server's forward.

No cell spans chips, so no exchange between chips can be left out.
`planted` patches the program for the length of a ``with`` block; the
benchmark's own runs plant nothing.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from harness import spec

Patch = Tuple[Any, str, Any]


def _state_unchanged(config) -> List[Patch]:
    from repro_torch.kernels import ops
    return [(ops, "vita_layer_fused", lambda x, *a, **k: x)]


def _half_batch(config) -> List[Patch]:
    from repro_torch.launch.vision_serve import VisionServer
    forward = VisionServer.forward

    def half(self, images):
        keep = -(-images.shape[0] // 2)
        out = forward(self, images[:keep])
        return torch.cat([out, out])[:images.shape[0]]
    return [(VisionServer, "forward", half)]


def _answer_altered(config) -> List[Patch]:
    """Each completion moves its first answer and puts the one moved
    before back, so the last answer served (the window's, whatever the
    host's speed) is the one left altered."""
    from repro_torch.launch.vision_serve import VisionServer
    complete = VisionServer.complete
    moved: Dict[str, Any] = {}

    def altered(self, inflight):
        n = complete(self, inflight)
        if inflight is not None and inflight.requests:
            if moved:
                moved["req"].logits = moved["logits"]
            req = inflight.requests[0]
            moved.update(req=req, logits=req.logits)
            req.logits = req.logits.copy()
            req.logits[0] += 1e-3 * np.abs(req.logits).max()
        return n
    return [(VisionServer, "complete", altered)]


def _control_tf32(config) -> List[Patch]:
    from repro_torch.launch.vision_serve import VisionServer
    ref = spec.load_reference(config["family"])
    sizes = config["sizes"]

    def in_tf32(self, images):
        return ref.forward(self.params, images, sizes, "tf32")
    return [(VisionServer, "forward", in_tf32)]


FAULTS: Dict[str, Callable[[Any], List[Patch]]] = {
    "state_unchanged": _state_unchanged, "half_batch": _half_batch,
    "answer_altered": _answer_altered, "control_tf32": _control_tf32}


@contextlib.contextmanager
def planted(name: str, config) -> Iterator[None]:
    """Plant fault ``name`` for ``config`` (a configuration file's
    contents) inside the block; ``"none"`` plants nothing."""
    patches = [] if name == "none" else FAULTS[name](config)
    saved = [(obj, attr, obj.__dict__[attr]) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
