"""Sharding rules (counterpart of `repro/distributed/sharding.py`): the
vision serving rules and the LM rules.

A spec is a tuple with one entry per dimension of its leaf: an axis name
(``"data"``, ``"model"``) or None (replicated along that dimension).  A
spec tree has the shape of the param tree, and a `QTensor` leaf gets a
`QTensor` of specs for its ``values`` and ``scale``, as the JAX pytree
gives.  The rules are the reference's, rule for rule:

  * everything replicates over the data axes (serving is data-parallel);
  * on a mesh with a ``model`` axis the per-head ``wq/wk/wv`` stacks
    (H, D, Dh) and their (H, 1, Dh) int8 scales shard the head dim; the
    Swin ``rel_bias`` tables ((2w-1)^2, H) shard dim 1 with them; the
    concat projection ``w_msa`` row-shards only where its block's heads
    shard and its rows are exactly H*Dh; ``w_up`` / ``b_up`` shard their
    columns and ``w_down`` its rows; the (1, C) int8 scales replicate
    through `_fits`; everything else replicates;
  * a dimension the axis does not divide falls back to replication
    (`_fits`), never to an error.

The executor (`core.schedule.ShardCtx`) reads the spec tree back to decide
where its all-reduces fire, so rule and collective cannot disagree.

The LM rules (`param_specs`, `train_batch_specs`, `cache_spec_tree`,
`fsdp_widen`, `opt_state_specs`) are the reference's, written over the
port's unstacked tree: ``layers`` is a flat list of blocks where the
reference stacks each pattern position over the superblocks, so a leaf
under ``layers[i]`` (and a cache leaf of layer i) gets the reference's
spec without its leading stacked None.  One case has no per-leaf
counterpart: where the data axis divides the superblock count, the
reference's FSDP / ZeRO-1 widening puts ``data`` on the stacked dim (it
shards the stack of layers); here it goes to the first unsharded dim of
the layer's own leaf that the data axis divides (the dim the reference
picks when the superblock count does not divide), so each data rank
still holds 1/data of the bytes; a leaf none of whose unsharded dims the
axis divides stays unsharded over data (the dry run deals such layers
whole over the data ranks, `launch.dryrun.dealt_layers`).  `fsdp_widen` sizes a layer's leaf as
the reference's stack (``cfg``'s superblock count times its own
elements) against ``min_elems``.

A mesh here is anything with ``axis_names`` and ``axis_sizes``: the
port's `launch.mesh.VisionMesh`, `abstract_mesh`, or the reference's
abstract meshes (the tests hold the two rule sets against each other on
those).  `shard_vision_params` / `shard_vision_batch` cut the rank's own
shard out of a whole tree or batch and move it to the rank's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed

from repro_torch import tree as tree_lib
from repro_torch.core.quant import QTensor

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks: enough to compute specs."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def abstract_mesh(shape: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axis_names))


def axis_size(mesh, name: str) -> int:
    """Size of a mesh axis by name (1 if absent)."""
    return dict(zip(mesh.axis_names, mesh.axis_sizes)).get(name, 1)


def _fits(shape: Tuple[int, ...], spec: Sequence, mesh) -> Spec:
    """Replace axis names that don't divide their dim with None."""
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= axis_size(mesh, a)
        fixed.append(ax if dim % size == 0 else None)
    return tuple(fixed)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_axis(batch_size: int, mesh):
    """Largest prefix of (pod, data) that divides the batch."""
    axes = dp_axes(mesh)
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    if axes and batch_size % size == 0:
        return axes if len(axes) > 1 else axes[0]
    if "data" in mesh.axis_names and \
            batch_size % axis_size(mesh, "data") == 0:
        return "data"
    return None


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------


_VISION_PER_HEAD = ("wq", "wk", "wv")


def _leaves(tree: Any, path: Tuple = ()):
    """(path, leaf) pairs of a param tree; a `QTensor` contributes its
    ``values`` and ``scale`` under those names, as JAX's pytree paths do."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif isinstance(tree, QTensor):
        yield path + ("values",), tree.values
        yield path + ("scale",), tree.scale
    else:
        yield path, tree


def _map(fn, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a param tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, QTensor):
        return QTensor(fn(path + ("values",), tree.values),
                       fn(path + ("scale",), tree.scale))
    return fn(path, tree)


def _names(path: Tuple) -> Tuple[str, ...]:
    return tuple(str(p) for p in path)


def _vision_head_map(params: Any) -> Dict[Tuple[str, ...], Tuple[int, int]]:
    """(block path-name prefix) -> (H, Dh), read off each block's ``wq``
    stack, so the ``w_msa`` decision uses the head count the stack's own
    ladder used."""
    heads: Dict[Tuple[str, ...], Tuple[int, int]] = {}
    for path, leaf in _leaves(params):
        names = _names(path)
        if "wq" in names and len(leaf.shape) == 3:
            heads[names[:names.index("wq")]] = (leaf.shape[0], leaf.shape[2])
    return heads


def vision_param_specs(params: Any, mesh) -> Any:
    """The spec tree of a vision param tree (float or int8 PTQ) on
    ``mesh`` (module docstring)."""
    has_model = "model" in mesh.axis_names
    m = axis_size(mesh, "model")
    heads = _vision_head_map(params) if has_model else {}

    def rule(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        names = _names(path)
        replicated = (None,) * len(shape)
        if not has_model:
            return replicated
        if len(shape) == 3 and any(n in _VISION_PER_HEAD for n in names):
            return _fits(shape, ("model", None, None), mesh)
        if "rel_bias" in names and len(shape) == 2:
            return _fits(shape, (None, "model"), mesh)
        if "w_msa" in names and len(shape) == 2:
            hd = heads.get(names[:names.index("w_msa")])
            if hd and hd[0] % m == 0 and shape[0] == hd[0] * hd[1]:
                return _fits(shape, ("model", None), mesh)
            return replicated
        if "w_up" in names and len(shape) == 2:
            return _fits(shape, (None, "model"), mesh)
        if "b_up" in names and len(shape) == 1:
            return _fits(shape, ("model",), mesh)
        if "w_down" in names and len(shape) == 2:
            return _fits(shape, ("model", None), mesh)
        return replicated

    return _map(rule, params)


def meta_tree(params: Any) -> Any:
    """The tree's shapes as meta tensors: all `vision_param_specs` reads,
    without the values."""
    return _map(lambda _, t: torch.empty(t.shape, dtype=t.dtype,
                                         device="meta"), params)


def vision_batch_spec(batch_size: int, mesh) -> Spec:
    """The micro-batch's spec: ``("data",)`` when the data axes divide the
    batch, else ``(None,)`` (replicated: every data row computes it)."""
    return (_batch_axis(batch_size, mesh),)


# ---------------------------------------------------------------------------
# LM rules (module docstring)
# ---------------------------------------------------------------------------


# name -> the spec of the (unstacked) leaf; "model" = tensor parallel
_COL = ("wq", "wk", "wv", "w_up", "w_gate", "w_x", "w_gate_branch",
        "w_in", "w_z", "w_q", "w_k", "w_v", "w_input_gate", "w_rec_gate",
        "unembed", "in_proj")
_ROW = ("wo", "w_down", "w_out", "w_msa")
_COL_BIAS = ("bq", "bk", "bv", "b_up", "b_in", "a_param", "gn_w")


def _param_rule(path_keys: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                cfg=None) -> Spec:
    """One LM param leaf's spec: Megatron column / row parallel, expert
    parallel MoE where the experts divide the model axis (else tensor
    parallel inside the experts), vocab-sharded embeddings, block-diagonal
    xLSTM weights per head; `_fits` degrades what does not divide."""
    name = path_keys[-1]
    in_moe = "moe" in path_keys
    if in_moe and name in ("w_up", "w_gate", "w_down"):
        if shape[0] % axis_size(mesh, "model") == 0:
            spec = ("model", None, None)                  # expert parallel
        elif name == "w_down":
            spec = (None, "model", None)                  # TP inside expert
        else:
            spec = (None, None, "model")
    elif in_moe and name == "router":
        spec = (None, None)
    elif name == "embed":
        spec = ("model", None)
    elif name in _COL and len(shape) == 2:
        spec = (None, "model")
    elif name in ("w_q", "w_k", "w_v") and len(shape) == 3:
        spec = (None, None, "model")       # block-diagonal per head (xLSTM)
    elif name in _ROW and len(shape) == 2:
        spec = ("model", None)
    elif name == "conv_w":
        spec = (None, "model")
    elif name in _COL_BIAS and len(shape) == 1:
        spec = ("model",)
    else:
        spec = (None,) * len(shape)
    return _fits(shape, spec, mesh)


def param_specs(cfg, params: Any, mesh) -> Any:
    """The spec tree of an LM param tree (leaves: tensors or anything
    with ``shape``, meta tensors included)."""
    return _map(lambda path, leaf: _param_rule(
        _names(path), tuple(leaf.shape), mesh, cfg), params)


def train_batch_specs(cfg, batch_shapes: Dict[str, Any],
                      mesh) -> Dict[str, Spec]:
    """Each batch entry split over the largest (pod, data) prefix that
    divides its batch dim."""
    return {k: (_batch_axis(v.shape[0], mesh),) + (None,) * (len(v.shape)
                                                             - 1)
            for k, v in batch_shapes.items()}


def cache_spec_tree(cfg, caches: Any, mesh, batch_size: int) -> Any:
    """Specs of the per-layer cache list: the batch dim over the data
    axes; attention k / v (B, Hkv, S, Dh) over the model axis by KV head,
    else by Dh; a recurrent state's last model-divisible dim."""
    bax = _batch_axis(batch_size, mesh)
    m = axis_size(mesh, "model")

    def rule(path, leaf) -> Spec:
        shape = tuple(leaf.shape)
        name = str(path[-1])
        rest = shape[1:]
        spec = [bax]
        if name in ("k", "v") and len(rest) == 3:        # (Hkv, S, Dh)
            hkv, _, dh = rest
            if hkv % m == 0:
                spec += ["model", None, None]
            elif dh % m == 0:
                spec += [None, None, "model"]
            else:
                spec += [None, None, None]
        elif name in ("h", "c", "n", "m", "conv", "C"):
            sub = [None] * len(rest)
            for i in range(len(rest) - 1, -1, -1):
                if rest[i] % m == 0:
                    sub[i] = "model"
                    break
            spec += sub
        else:
            spec += [None] * len(rest)
        return _fits(shape, tuple(spec), mesh)

    return _map(rule, caches)


def _widen_data(spec: Spec, shape: Tuple[int, ...], dsize: int) -> Spec:
    """``data`` on the first unsharded dim it divides (module
    docstring)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, ax) in enumerate(zip(shape, dims)):
        if ax is None and dim % dsize == 0 and dsize > 1:
            dims[i] = "data"
            break
    return tuple(dims)


def fsdp_widen(param_spec_tree: Any, params: Any, mesh,
               min_elems: int = 1 << 20, cfg=None) -> Any:
    """ZeRO-3 / FSDP: params of at least ``min_elems`` elements (a layer's
    leaf counted as its reference stack: ``cfg.n_superblocks`` times its
    own, 1 time without ``cfg``) also shard over ``data`` at rest."""
    dsize = axis_size(mesh, "data")
    stack = cfg.n_superblocks if cfg is not None else 1

    def widen(path, leaf):
        spec = tree_lib.at(param_spec_tree, path)
        n = leaf.numel() if hasattr(leaf, "numel") else \
            int(torch.Size(leaf.shape).numel())
        if "layers" in _names(path):
            n *= stack
        if n < min_elems or dsize <= 1:
            return spec
        return _widen_data(spec, tuple(leaf.shape), dsize)

    return _map(widen, params)


def opt_state_specs(param_spec_tree: Any, params: Any = None, mesh=None,
                    zero1: bool = True) -> Dict[str, Any]:
    """Optimizer-state specs: the moments as the params, and by default
    (ZeRO-1) also over ``data`` on their first data-divisible unsharded
    dim; ``count`` replicated."""
    mom = param_spec_tree
    if zero1 and params is not None and mesh is not None:
        dsize = axis_size(mesh, "data")
        mom = _map(lambda path, leaf: _widen_data(
            tree_lib.at(param_spec_tree, path), tuple(leaf.shape), dsize),
            params)
    return {"m": mom, "v": mom, "count": ()}


# ---------------------------------------------------------------------------
# Placement: the rank's own shard on the rank's device
# ---------------------------------------------------------------------------


def _local(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The rank's block of ``t`` under ``spec`` (a slice per sharded dim,
    at the rank's coordinate on that axis), on the rank's device."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = axis_size(mesh, ax)
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.coord(ax) * size, size)
    return t.contiguous().to(mesh.device)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a param tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    if isinstance(tree, QTensor):
        return QTensor(fn(tree.values, specs.values),
                       fn(tree.scale, specs.scale))
    return fn(tree, specs)


def shard_vision_params(params: Any, mesh) -> Any:
    """The rank's local shard of a whole vision param tree, on its
    device: sharded leaves sliced, replicated ones moved whole."""
    return _zip_map(lambda leaf, spec: _local(leaf, spec, mesh), params,
                    vision_param_specs(params, mesh))


def shard_vision_batch(batch: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's rows of a (B, ...) batch on its device: its data shard
    when the data axis divides B, else every row."""
    spec = vision_batch_spec(batch.shape[0], mesh)
    return _local(batch, spec + (None,) * (batch.dim() - 1), mesh)


def gather_batch(out: torch.Tensor, mesh, sharded: bool) -> torch.Tensor:
    """The whole micro-batch's rows on every rank of ``mesh``, from each
    rank's ``out`` (its rows when ``sharded``, else every row): the rank
    at model coordinate 0 of each data row writes its rows into a zeroed
    buffer and the buffer is summed over the mesh (an all-reduce: gloo
    has no all-gather for CUDA tensors; adding zeros is exact)."""
    if mesh.size == 1:
        return out
    d, m = mesh.coords
    rows = out.shape[0]
    buf = torch.zeros((rows * mesh.data if sharded else rows,)
                      + tuple(out.shape[1:]), dtype=torch.float32,
                      device=out.device)
    if m == 0 and (sharded or d == 0):
        off = d * rows if sharded else 0
        buf[off:off + rows] = out
    torch.distributed.all_reduce(buf, group=mesh.group)
    return buf.to(out.dtype)
