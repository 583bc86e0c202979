"""Rank-side helpers for the port's mesh tests: module-level functions a
test sends to the ranks of a `repro_torch.launch.mesh` world.  The ranks
import this module, so it imports torch and the port only (no JAX)."""

import torch
import torch.distributed as dist

from repro_torch.kernels import ref

# The operands of the layer references that split over the model axis,
# by position, and the dim each splits: the per-head stacks, their concat
# rows (head-major, so a contiguous block of rows is a block of heads),
# the per-head scales and window bias; the MLP's hidden columns.
# Keyed by int8 (True) or float (False).
SPLIT = {False: {1: 0, 2: 0, 3: 0, 4: 0, 9: 1, 10: 0, 11: 0, 13: 0},
         True: {1: 0, 2: 0, 3: 0, 4: 0, 5: 1, 6: 0, 8: 0, 9: 0, 10: 0,
                12: 0, 18: 0, 20: 0}}


def _shard(t, dim: int, mesh):
    n = mesh.model
    size = t.shape[dim] // n
    return t.narrow(dim, mesh.coord("model") * size, size).contiguous()


def layer_with_axes(mesh, int8: bool, args):
    """`ref.vita_layer_ref` (or the int8 one) on this rank's shards of the
    whole operands ``args`` (heads, their concat rows, MLP columns),
    all-reduced over the model axis."""
    if mesh.rank is None:
        return None
    split = SPLIT[int8]
    local = [a if a is None or i not in split else
             _shard(a, split[i], mesh) for i, a in enumerate(args)]
    fn = ref.vita_layer_int8_ref if int8 else ref.vita_layer_ref
    return fn(*local, msa_axis=mesh.model_group, mlp_axis=mesh.model_group)


def fail_on(mesh, rank: int):
    """Raise on ``rank``; every other rank waits in an all-reduce that the
    failed rank never joins."""
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    t = torch.zeros(1)
    dist.all_reduce(t, group=mesh.group)
    return t


def rank_coords(mesh):
    """This rank's (data, model) coordinates in ``mesh``."""
    return mesh.coords


def tanh_stage(p, x):
    """One GPipe stage of the JAX package's pipeline test."""
    w, b = p
    return torch.tanh(x @ w + b)


def gpipe(mesh, axis, ws, bs, mbs):
    """`pipeline_apply` of the tanh stages on this rank (stage = its
    coordinate along ``axis``); the outputs as numpy."""
    from repro_torch.distributed.pipeline import pipeline_apply
    if mesh.rank is None:
        return None
    d = mesh.coord(axis)
    out = pipeline_apply(tanh_stage, (torch.from_numpy(ws[d]),
                                      torch.from_numpy(bs[d])),
                         torch.from_numpy(mbs), mesh, axis)
    return out.numpy()
