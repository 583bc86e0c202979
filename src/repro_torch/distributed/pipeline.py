"""Pipeline parallelism: the GPipe rotation schedule over a mesh axis
(counterpart of `repro/distributed/pipeline.py`).

The JAX package builds the schedule in one program with `shard_map` and
`lax.ppermute`; the port runs SPMD, one process per mesh position, and
every rank of the axis calls `pipeline_apply` with its own stage's
parameters:

  * the rank at coordinate d of ``axis`` is stage d;
  * at tick t, stage 0 takes microbatch t (the last one again once they
    run out, as the JAX package clips t); every stage applies its stage
    to the activation it holds; the activations rotate d -> d+1 (a
    send / recv pair to the next and previous rank, where the JAX
    package's `ppermute` rotates them);
  * after n_mb + n_stages - 1 ticks the last stage holds every
    microbatch's output, which it broadcasts over the axis (the
    (n_stages-1)-tick bubble is the usual GPipe cost, `bubble_fraction`).

Over gloo (the CPU, or ranks sharing one card) the rotation stages CUDA
activations through the host; NCCL sends them card to card.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist


def _axis_ranks(mesh, axis: str) -> List[int]:
    """The world ranks of this rank's line along ``axis``, by coordinate."""
    d, m = mesh.coords
    if axis == "data":
        return [i * mesh.model + m for i in range(mesh.data)]
    return [d * mesh.model + j for j in range(mesh.model)]


def _wire(t: torch.Tensor, via_host: bool) -> torch.Tensor:
    """``t``'s bytes (on the host where ``via_host``), what a send or a
    broadcast carries whatever the dtype."""
    return (t.cpu() if via_host else t).contiguous().view(torch.uint8)


def _rotate(y: torch.Tensor, nxt: int, prv: int, group,
            via_host: bool) -> torch.Tensor:
    """Send ``y`` to rank ``nxt`` and receive the same shape from
    ``prv``."""
    send = _wire(y, via_host)
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, send, nxt, group),
             dist.P2POp(dist.irecv, recv, prv, group)]):
        work.wait()
    return recv.view(y.dtype).to(y.device)


def pipeline_apply(stage_fn: Callable, stage_params: Any,
                   microbatches: torch.Tensor, mesh,
                   axis: str = "data") -> torch.Tensor:
    """``y = stage_{D-1}(...stage_0(x))`` for each microbatch by the GPipe
    rotation (module docstring), called by every rank of ``mesh`` (a
    `launch.mesh.VisionMesh`) with its stage's params.

    stage_fn(stage_params, x) -> y        (same shape as x)
    microbatches: (n_mb, ...), the same on every rank
    returns: (n_mb, ...) outputs, on every rank of the axis
    """
    group = mesh.data_group if axis == "data" else mesh.model_group
    ranks = _axis_ranks(mesh, axis)
    n_stages, d = len(ranks), mesh.coord(axis)
    n_mb = microbatches.shape[0]
    via_host = microbatches.is_cuda and mesh.backend != "nccl"
    x = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(n_mb + n_stages - 1):
        if d == 0:
            x = microbatches[min(t, n_mb - 1)]
        y = stage_fn(stage_params, x)
        m = t - (n_stages - 1)
        if d == n_stages - 1 and 0 <= m < n_mb:
            outs[m] = y
        if n_stages > 1:
            x = _rotate(y, ranks[(d + 1) % n_stages],
                        ranks[(d - 1) % n_stages], group, via_host)
    if n_stages > 1:
        wire = _wire(outs, via_host)
        dist.broadcast(wire, src=ranks[-1], group=group)
        outs = wire.view(outs.dtype).to(microbatches.device)
    return outs


def bubble_fraction(n_stages: int, n_mb: int) -> float:
    """GPipe bubble overhead: (D-1)/(D-1+M)."""
    return (n_stages - 1) / (n_stages - 1 + n_mb)
