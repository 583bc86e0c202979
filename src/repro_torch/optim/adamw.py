"""AdamW with decoupled weight decay and global-norm clipping
(counterpart of `repro/optim/adamw.py`).

Functional, as the JAX package's: the state mirrors the param tree, with
``m`` and ``v`` in float32 whatever the parameter dtype (bf16 params,
fp32 moments), and ``count`` an int32 0-d tensor on the host (the bias
corrections read it without a device sync).  The update runs under
``no_grad`` and returns new trees.

Weight decay follows the JAX leaf's rank (`decay_mask`): the JAX package
decays a leaf of rank >= 2, and it stacks every per-layer leaf over the
superblocks, so there a per-layer norm weight, bias or 1-D gate vector
has rank 2 and is decayed while the unstacked ``final_norm`` is not.
The port keeps ``layers`` as a flat list of unstacked blocks, so a leaf
under ``layers`` counts one rank more than its own: the same leaves
decay on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def decays(path: tree_lib.Path, leaf: torch.Tensor) -> bool:
    """True where AdamW decays the leaf: its rank in the JAX package's
    tree (its own, plus the superblock axis under ``layers``) is >= 2
    (module docstring)."""
    return leaf.dim() + (1 if "layers" in path else 0) >= 2


def decays_by_own_rank(path: tree_lib.Path, leaf: torch.Tensor) -> bool:
    """The JAX rule on a tree that stacks nothing (a vision tree, whose
    ``layers`` is a list of blocks in both packages): rank >= 2."""
    return leaf.dim() >= 2


def decay_mask(params: Any) -> Any:
    """`decays` of every leaf, as a tree like ``params``."""
    return tree_lib.map_with_path(decays, params)


def adamw_init(params: Any) -> Any:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": tree_lib.tree_map(zeros, params),
            "v": tree_lib.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """(grads scaled so their global norm is at most ``max_norm``, each in
    its own dtype; the norm before clipping, float32)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_lib.leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: (g.float() * scale).to(g.dtype),
                             grads), gnorm


@torch.no_grad()
def adamw_update(grads: Any, state: Any, params: Any, lr,
                 cfg: AdamWConfig = AdamWConfig(),
                 decay: Callable = decays) -> Tuple[Any, Any, dict]:
    """(new params, new state, {"grad_norm"}) after one clipped AdamW step
    at learning rate ``lr`` (a float32 0-d tensor or a float).
    ``decay(path, leaf)`` picks the leaves weight decay applies to
    (default: an LM tree's `decays`; `decays_by_own_rank` for a vision
    tree)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    def upd(path, p, g, m, v):
        # The JAX package's arithmetic in its order, updating fresh
        # tensors in place so a large leaf holds few temporaries.
        gf = g.float()
        m_new = cfg.b1 * m
        m_new += (1 - cfg.b1) * gf
        v_new = cfg.b2 * v
        v_new += (1 - cfg.b2) * torch.square(gf)
        step = torch.sqrt(v_new / b2c).add_(cfg.eps)
        step = torch.div(m_new / b1c, step, out=step)
        if decay(path, p):
            step += cfg.weight_decay * p.float()
        step.mul_(lr)
        return torch.sub(p.float(), step, out=step).to(p.dtype), m_new, \
            v_new

    new_p, m, v = tree_lib.unzip(params, tree_lib.map_with_path(
        upd, params, grads, state["m"], state["v"]), 3)
    return new_p, {"m": m, "v": v, "count": count}, {"grad_norm": gnorm}
