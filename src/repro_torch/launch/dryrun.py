"""Multi-pod dry run (counterpart of `repro/launch/dryrun.py`): shows that
the distribution config of every (arch x shape) cell is coherent on the
production meshes (16 x 16 single pod, 2 x 16 x 16 multi-pod), without
allocating a weight.

For every applicable cell and mesh this script

  1. builds the cell's param tree, inputs, optimizer state and caches on
     the meta device (shapes and dtypes, no storage; `registry.input_specs`),
  2. applies the sharding rules (`distributed.sharding`: `param_specs`,
     `fsdp_widen` where the config asks, `opt_state_specs`,
     `train_batch_specs`, `cache_spec_tree`) and asserts that every spec
     tree matches its leaf tree and that every sharded dim divides by its
     axes (there is no compiler here to fail loudly instead),
  3. traces the cell's step (train, prefill or decode, at the cell's
     global shapes) on the meta device under
     `torch.utils.flop_counter.FlopCounterMode`,
  4. writes one JSON record per cell to ``--out``
     (default ``results/dryrun_torch/``).

What the record holds, against the JAX package's:

  * the same integers as JAX for ``state_bytes_per_device_analytic``,
    ``params_bytes_per_device``, ``cache_bytes_per_device``,
    ``activation_bytes_per_device_analytic``, ``model_flops_global`` and
    ``tokens_per_step`` (`_tree_bytes_per_device` and
    `analytic_activation_bytes` are JAX's, over the port's spec trees;
    `dealt_layers` covers the one case where the port's per-layer specs
    cannot say what JAX's stacked ones do);
  * ``flops_global``: the traced step's FLOPs over the whole global batch,
    and ``flops_per_device_even_split`` = flops_global / n_devices.  It is
    not XLA's partitioned count (``hlo_flops_per_device``): FlopCounterMode
    counts only matmuls, convolutions and attention (elementwise work,
    softmax, norms and the optimizer count 0), and the split assumes
    perfect balance.  A block whose plain version loops in Python over
    tokens (sLSTM; the RG-LRU scan of ``rec``; mLSTM's recurrent prefill)
    would make tens of millions of dispatches at 32k tokens, so the step
    is traced with such blocks as zero-FLOP stand-ins of the same output
    shape, and each such block alone (forward, and backward in a train
    cell) is traced at ``SHORT_T`` tokens and its count extrapolated
    linearly to the cell's length (exact: their FLOPs are linear in T;
    ``flops_extrapolated`` names the blocks);
  * ``memory_analysis``: ``argument_bytes`` and ``output_bytes`` per
    device from the specs; ``temp_bytes`` and ``alias_bytes`` are null,
    since there is no compiler's buffer assignment to read them from;
  * ``collectives``: a ring-model count of what the specs imply, with
    JAX's wire factors (`wire_bytes`) and keys, marked ``"source":
    "analytic"`` (XLA's partitioned HLO, which JAX parses, does not
    exist here): the gradient all-reduce over the data axes (train), the
    all-gathers (and, training, reduce-scatters) of FSDP-widened leaves,
    and two activation all-reduces per block over a model axis larger
    than 1 (and two more per block in a train cell's backward).

Run (no device needed; it imports no JAX):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch h2o-danube-1.8b --shape train_4k --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch import tree as tree_lib
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer as tr
from repro_torch.models.layers import MetaGenerator

# Blocks whose plain version loops over tokens, by step kind.
LOOPED = {"train": ("rec", "slstm"), "prefill": ("rec", "mlstm", "slstm"),
          "decode": ()}
SHORT_T = (16, 32)
FSDP_MIN_ELEMS = 1 << 20          # `sharding.fsdp_widen`'s default


# ---------------------------------------------------------------------------
# Analytic bytes (the JAX package's)
# ---------------------------------------------------------------------------


def _apply_variant(cfg, variant: str):
    """'remat=1,dtype=float32' -> dataclasses.replace on the config."""
    if not variant:
        return cfg
    kw = {}
    for item in variant.split(","):
        if not item:
            continue
        k, v = item.split("=")
        field = {f.name: f for f in dataclasses.fields(cfg)}[k]
        if field.type in ("bool", bool):
            kw[k] = v not in ("0", "false", "False")
        elif field.type in ("int", int) or k in ("window",):
            kw[k] = int(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def _axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def _spec_leaves(specs: Any, path: Tuple = ()):
    """(path, spec) of a spec tree, whose leaves are spec tuples."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, specs


def _tree_bytes_per_device(shape_tree, spec_tree, mesh,
                           dealt=frozenset()) -> int:
    """JAX's per-device byte count of a tree under its specs.  The leaves
    at the paths in ``dealt`` (`dealt_layers`) are counted whole and
    their sum divided by the data axis."""
    axis = _axes(mesh)

    def leaf_bytes(leaf, spec):
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= axis[a]
        n = 1
        for s in leaf.shape:
            n *= s
        return n * leaf.dtype.itemsize // max(denom, 1)

    total = dealt_total = 0
    for path, leaf in tree_lib.leaves_with_path(shape_tree):
        n = leaf_bytes(leaf, tree_lib.at(spec_tree, path))
        if path in dealt:
            dealt_total += n
        else:
            total += n
    return int(total + dealt_total // axis.get("data", 1))


def dealt_layers(cfg, params, widened, mesh, min_elems=None) -> set:
    """Paths of the layer leaves that the JAX package's ZeRO-1 / FSDP
    widening shards over ``data`` on its stacked superblock dim (the data
    axis divides the superblock count) and whose own dims the data axis
    cannot split, so the port's per-layer spec (``widened``) stays
    unsharded over data (a tensor-parallel bias, say).  The layers of
    such a leaf are dealt whole over the data ranks, as the stacked
    sharding places them, and count 1/data of their bytes a device.
    ``min_elems``: FSDP's threshold, on the stacked size."""
    dsize = _axes(mesh).get("data", 1)
    if dsize <= 1 or cfg.n_superblocks % dsize:
        return set()
    return {path for path, leaf in tree_lib.leaves_with_path(params)
            if "layers" in path and "data" not in tree_lib.at(widened, path)
            and (min_elems is None
                 or leaf.numel() * cfg.n_superblocks >= min_elems)}


def analytic_activation_bytes(cfg, cell, mesh) -> int:
    """Per-device activation HBM traffic estimate for ONE forward pass
    (bf16, write+read once), with the kernels' execution model: no (S,S)
    score materialization, ff intermediates sharded over `model` (the
    JAX package's formula, integer for integer)."""
    axis = _axes(mesh)
    dp = axis.get("pod", 1) * axis.get("data", 1)
    tp = axis.get("model", 1)
    if cell.kind == "decode":
        tokens_dev = max(cell.global_batch // dp, 1)
    else:
        tokens_dev = max(cell.global_batch * cell.seq_len // dp, 1)
    d = cfg.d_model
    per_layer = {}
    per_layer["attn"] = 6 * d + (2 * cfg.n_heads * cfg.hd +
                                 2 * cfg.n_kv_heads * cfg.hd) // tp
    per_layer["rec"] = 6 * d + 6 * (cfg.lru_width or d) // tp
    per_layer["mlstm"] = 6 * d + 12 * d // tp
    per_layer["slstm"] = 6 * d + 8 * d
    ff = (cfg.moe.d_ff * cfg.moe.top_k * 3 if cfg.moe
          else cfg.d_ff * (3 if cfg.gated else 2))
    elems = 0
    for kind in cfg.pattern:
        elems += per_layer[kind] + ff // tp + 2 * d
    elems *= cfg.n_superblocks
    # unembed logits (fp32 cast) once
    logits = tokens_dev * cfg.padded_vocab // tp * 4 if cell.kind != \
        "decode" else 0
    return int(2 * tokens_dev * elems * 2 + logits)   # write+read, bf16


def check_specs(what: str, tree: Any, specs: Any, mesh) -> None:
    """Assert that ``specs`` has ``tree``'s structure, one entry per dim
    of each leaf, each mesh axis at most once, and that every sharded dim
    divides by the product of its axes."""
    axis = _axes(mesh)
    leaves = dict(tree_lib.leaves_with_path(tree))
    spec_of = dict(_spec_leaves(specs))
    if set(leaves) != set(spec_of):
        raise AssertionError(f"{what}: spec tree does not match its leaves "
                             f"({sorted(set(leaves) ^ set(spec_of))[:4]})")
    for path, leaf in leaves.items():
        spec = spec_of[path]
        if not isinstance(spec, tuple) or len(spec) != leaf.dim():
            raise AssertionError(f"{what} {tree_lib.path_key(path)}: spec "
                                 f"{spec!r} for shape {tuple(leaf.shape)}")
        used = []
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            names = ax if isinstance(ax, tuple) else (ax,)
            size = math.prod(axis[a] for a in names)
            if dim % size:
                raise AssertionError(
                    f"{what} {tree_lib.path_key(path)}: dim {dim} does not "
                    f"divide by {names} ({size})")
            used += names
        if len(used) != len(set(used)):
            raise AssertionError(f"{what} {tree_lib.path_key(path)}: an "
                                 f"axis twice in {spec!r}")


# ---------------------------------------------------------------------------
# Analytic collectives (ring model, the JAX package's wire factors)
# ---------------------------------------------------------------------------


def wire_bytes(kind: str, nbytes: int, gs: int) -> float:
    """Bytes on the wire per device of one collective whose output is
    ``nbytes`` per device, over a group of ``gs`` (JAX's ring factors)."""
    if kind == "all-reduce":
        return 2.0 * (gs - 1) / max(gs, 1) * nbytes
    if kind == "all-gather":
        return (gs - 1) / max(gs, 1) * nbytes        # output = gathered
    if kind == "reduce-scatter":
        return (gs - 1) * nbytes                     # output = shard
    if kind == "all-to-all":
        return (gs - 1) / max(gs, 1) * nbytes
    return float(nbytes)                             # collective-permute


def _batch_group(batch: int, mesh) -> int:
    """How many ways the batch dim splits (`_batch_axis`'s axes)."""
    ax = shd._batch_axis(batch, mesh)
    if ax is None:
        return 1
    return math.prod(_axes(mesh)[a]
                     for a in (ax if isinstance(ax, tuple) else (ax,)))


def analytic_collectives(cfg, cell, mesh, params, pspec_base, pspec,
                         dealt=frozenset()) -> Dict[str, Any]:
    """Per-device collective traffic implied by the specs (module
    docstring), in JAX's record keys."""
    axis = _axes(mesh)
    dsize, psize, tp = (axis.get("data", 1), axis.get("pod", 1),
                        axis.get("model", 1))
    dp = dsize * psize
    train = cell.kind == "train"
    ops = []

    def op(kind, nbytes, gs, what):
        if gs > 1 and nbytes > 0:
            ops.append((int(wire_bytes(kind, nbytes, gs)), kind, gs, what))

    for path, leaf in tree_lib.leaves_with_path(params):
        what = tree_lib.path_key(path)
        full = _tree_bytes_per_device(leaf, tree_lib.at(pspec_base, path),
                                      mesh)
        widened = "data" in tree_lib.at(pspec, path) or path in dealt
        if widened:
            shard = full // dsize
            op("all-gather", full, dsize, what)
            if train:
                op("reduce-scatter", shard, dsize, what)
                op("all-reduce", shard, psize, what)
        elif train:
            op("all-reduce", full, dp, what)
    if tp > 1:
        tokens = (cell.global_batch // _batch_group(cell.global_batch, mesh)
                  ) * (1 if cell.kind == "decode" else cell.seq_len)
        act = tokens * cfg.d_model * cfg.param_dtype.itemsize
        per_block = 4 if train else 2
        for i in range(cfg.n_layers * per_block):
            op("all-reduce", act, tp, f"activation/{i // per_block}")
    stats = {"source": "analytic", "bytes_total": 0, "by_kind": {},
             "by_group_size": {}, "op_count": len(ops), "top_ops": []}
    for wire, kind, gs, _ in ops:
        stats["bytes_total"] += wire
        stats["by_kind"][kind] = stats["by_kind"].get(kind, 0) + wire
        stats["by_group_size"][str(gs)] = \
            stats["by_group_size"].get(str(gs), 0) + wire
    stats["top_ops"] = [list(o) for o in sorted(ops, reverse=True)[:10]]
    return stats


# ---------------------------------------------------------------------------
# FLOPs: a meta-device trace
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _stand_ins(kinds: Tuple[str, ...]):
    """Within the context, the mixers of ``kinds`` return zeros of their
    output's shape (and a fresh cache in prefill): no counted FLOPs and no
    Python loop over tokens (module docstring)."""
    forward, prefill = tr._mixer_forward, tr._mixer_prefill

    def stand_in_forward(kind, p, x, cfg):
        return x * 0 if kind in kinds else forward(kind, p, x, cfg)

    def stand_in_prefill(kind, p, x, cfg, cache_len):
        if kind not in kinds:
            return prefill(kind, p, x, cfg, cache_len)
        return x * 0, tr._mixer_init_cache(kind, cfg, x.shape[0], cache_len,
                                           cfg.param_dtype, x.device)

    tr._mixer_forward, tr._mixer_prefill = stand_in_forward, stand_in_prefill
    try:
        yield
    finally:
        tr._mixer_forward, tr._mixer_prefill = forward, prefill


def _counts(fc: FlopCounterMode) -> Dict[str, int]:
    return {str(k): int(v)
            for k, v in fc.get_flop_counts().get("Global", {}).items()}


def mixer_flops(kind: str, cfg, step_kind: str, batch: int, t: int,
                cache_len: int) -> Dict[str, int]:
    """FLOPs by op of one ``kind`` mixer over (batch, t) tokens on meta:
    its prefill, or in a train step its forward and backward (the
    forward twice under ``remat``)."""
    p = tr._mixer_init(kind, MetaGenerator(), cfg, cfg.param_dtype)
    x = torch.empty((batch, t, cfg.d_model), dtype=cfg.param_dtype,
                    device="meta")
    with FlopCounterMode(display=False) as fc:
        if step_kind == "train":
            live = [leaf.detach().requires_grad_()
                    for leaf in [x] + tree_lib.leaves(p)]
            with torch.enable_grad():
                y = tr._mixer_forward(kind, tree_lib.unflatten(p, live[1:]),
                                      live[0], cfg)
                torch.autograd.grad(y, live, torch.empty_like(y),
                                    allow_unused=True)
        else:
            tr._mixer_prefill(kind, p, x, cfg, cache_len)
    total = _counts(fc)
    if step_kind == "train" and cfg.remat:
        with FlopCounterMode(display=False) as fc:
            tr._mixer_forward(kind, p, x, cfg)
        for k, v in _counts(fc).items():
            total[k] = total.get(k, 0) + v
    return total


def extrapolated_mixer_flops(kind: str, cfg, step_kind: str, batch: int,
                             t: int, cache_len: int) -> Dict[str, int]:
    """`mixer_flops` at ``t`` tokens from traces at the two `SHORT_T`
    lengths, linearly (exact where the FLOPs are a + b t, as for every
    block of `LOOPED`; asserted to give integers)."""
    t1, t2 = SHORT_T
    f1 = mixer_flops(kind, cfg, step_kind, batch, t1, cache_len)
    f2 = mixer_flops(kind, cfg, step_kind, batch, t2, cache_len)
    out = {}
    for op in set(f1) | set(f2):
        a, b = f1.get(op, 0), f2.get(op, 0)
        slope, rem = divmod(b - a, t2 - t1)
        if rem:
            raise AssertionError(f"{kind} {op}: FLOPs not linear in T")
        out[op] = a + slope * (t - t1)
    return out


def trace_flops(step_fn, args, cfg, step_kind: str, batch: int, t: int,
                cache_len: int) -> Tuple[Dict[str, int], Dict[str, Any]]:
    """(FLOPs by op of ``step_fn(*args)`` traced on meta, the blocks
    extrapolated: {kind: {"layers", "short_t"}})."""
    kinds = tuple(k for k in LOOPED[step_kind] if k in cfg.pattern)
    with _stand_ins(kinds), FlopCounterMode(display=False) as fc:
        step_fn(*args)
    counts = _counts(fc)
    extrapolated = {}
    for kind in kinds:
        layers = tr.layer_kinds(cfg).count(kind)
        per = extrapolated_mixer_flops(kind, cfg, step_kind, batch, t,
                                       cache_len)
        for op, v in per.items():
            counts[op] = counts.get(op, 0) + layers * v
        extrapolated[kind] = {"layers": layers, "short_t": list(SHORT_T)}
    return counts, extrapolated


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------


def build_cell(cfg, cell, mesh) -> Dict[str, Any]:
    """A cell's trees on meta, their specs (checked: `check_specs`), its
    step and arguments, and the analytic bytes."""
    params = tr.init_params(cfg, 0, "meta")
    pspec_base = shd.param_specs(cfg, params, mesh)
    pspec, dealt = pspec_base, set()
    if cfg.fsdp:
        pspec = shd.fsdp_widen(pspec_base, params, mesh, cfg=cfg)
        dealt = dealt_layers(cfg, params, pspec, mesh, FSDP_MIN_ELEMS)
    check_specs("params", params, pspec, mesh)
    params_bytes = _tree_bytes_per_device(params, pspec, mesh, dealt)
    b = cell.global_batch
    tok_spec = (shd._batch_axis(b, mesh),)
    out = {"params": params, "pspec_base": pspec_base, "pspec": pspec,
           "dealt": dealt, "params_bytes": params_bytes}

    if cell.kind == "train":
        batch = configs.train_inputs(cfg, cell)
        bspec = shd.train_batch_specs(cfg, batch, mesh)
        opt = steps_lib.init_opt_state(params)
        ospec = {"adam": shd.opt_state_specs(pspec, params, mesh)}
        check_specs("batch", batch, bspec, mesh)
        check_specs("opt_state", opt, ospec, mesh)
        step = torch.zeros((), dtype=torch.int32)
        mom = dealt_layers(cfg, params, ospec["adam"]["m"], mesh)
        odealt = {("adam", k) + p for k in ("m", "v") for p in mom}
        state_bytes = params_bytes + _tree_bytes_per_device(opt, ospec, mesh,
                                                            odealt)

        def out_bytes(res):
            new_p, new_o, metrics = res
            return (_tree_bytes_per_device(new_p, pspec, mesh, dealt)
                    + _tree_bytes_per_device(new_o, ospec, mesh, odealt)
                    + sum(m.numel() * m.dtype.itemsize
                          for m in metrics.values()))

        return dict(out, step_fn=steps_lib.make_train_step(cfg),
                    args=(params, opt, batch, step), state_bytes=state_bytes,
                    arg_bytes=state_bytes + step.dtype.itemsize
                    + _tree_bytes_per_device(batch, bspec, mesh),
                    out_bytes=out_bytes, tokens=b * cell.seq_len)

    if cell.kind == "prefill":
        batch = {k: v for k, v in configs.prefill_inputs(cfg, cell).items()
                 if k != "labels"}
        bspec = shd.train_batch_specs(cfg, batch, mesh)
        check_specs("batch", batch, bspec, mesh)
        caches = tr.init_caches(cfg, b, cell.seq_len, device="meta")
        out.update(step_fn=steps_lib.make_prefill_step(cfg, cell.seq_len),
                   args=(params, batch), state_bytes=params_bytes,
                   arg_bytes=params_bytes
                   + _tree_bytes_per_device(batch, bspec, mesh),
                   tokens=b * cell.seq_len)
    else:
        io, caches = configs.decode_inputs(cfg, cell)
        out.update(step_fn=steps_lib.make_decode_step(cfg),
                   args=(params, io["tokens"], caches, io["pos"]),
                   tokens=b)             # one token per sequence per step
    cspec = shd.cache_spec_tree(cfg, caches, mesh, b)
    check_specs("caches", caches, cspec, mesh)
    if cell.kind == "decode":
        out["state_bytes"] = params_bytes + _tree_bytes_per_device(
            caches, cspec, mesh)
        out["arg_bytes"] = out["state_bytes"] + sum(
            _tree_bytes_per_device(v, tok_spec, mesh) for v in io.values())

    def out_bytes(res):
        tok, new_caches = res
        return (_tree_bytes_per_device(tok, tok_spec, mesh)
                + _tree_bytes_per_device(new_caches, cspec, mesh))

    out["out_bytes"] = out_bytes
    return out


def analytic_fields(cfg, cell, mesh, built: Dict[str, Any]) -> Dict[str, int]:
    """The record's fields that equal the JAX package's integers."""
    return {
        "tokens_per_step": built["tokens"],
        "state_bytes_per_device_analytic": built["state_bytes"],
        "params_bytes_per_device": built["params_bytes"],
        "cache_bytes_per_device":
            max(built["state_bytes"] - built["params_bytes"], 0)
            if cell.kind == "decode" else 0,
        "activation_bytes_per_device_analytic":
            analytic_activation_bytes(cfg, cell, mesh),
        "model_flops_global": steps_lib.model_flops(
            cfg, built["params"], cell.kind, built["tokens"]),
    }


def lower_cell(arch: str, shape: str, mesh, *, variant: str = "",
               donate: bool = True) -> Dict[str, Any]:
    """The record of one (arch, shape) cell on ``mesh`` (module
    docstring)."""
    cfg = _apply_variant(configs.get(arch), variant)
    cell = configs.SHAPES[shape]
    ok, why = configs.cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape} skipped: {why}")
    n_dev = math.prod(mesh.axis_sizes)
    t0 = time.time()
    built = build_cell(cfg, cell, mesh)
    t_setup = time.time() - t0

    captured = {}

    def traced(*a):
        captured["out"] = built["step_fn"](*a)

    by_op, extrapolated = trace_flops(
        traced, built["args"], cfg, cell.kind, cell.global_batch,
        1 if cell.kind == "decode" else cell.seq_len,
        cfg.kv_cache_len(cell.seq_len))
    t_trace = time.time() - t0 - t_setup
    flops = int(sum(by_op.values()))

    return {
        "arch": arch, "shape": shape, "variant": variant,
        "mesh": list(mesh.axis_sizes), "axes": list(mesh.axis_names),
        "n_devices": int(n_dev), "kind": cell.kind,
        "flops_global": flops,
        "flops_per_device_even_split": flops / n_dev,
        "flops_by_op": dict(sorted(by_op.items())),
        "flops_extrapolated": extrapolated,
        "memory_analysis": {
            "argument_bytes": int(built["arg_bytes"]),
            "output_bytes": int(built["out_bytes"](captured["out"])),
            "temp_bytes": None, "alias_bytes": None, "donate": donate,
        },
        **analytic_fields(cfg, cell, mesh, built),
        "collectives": analytic_collectives(
            cfg, cell, mesh, built["params"], built["pspec_base"],
            built["pspec"], built["dealt"]),
        "setup_s": round(t_setup, 2), "trace_s": round(t_trace, 2),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def cell_filename(arch: str, shape: str, mesh_name: str,
                  variant: str = "") -> str:
    v = ("__" + variant.replace("=", "").replace(",", "_")) if variant else ""
    return f"{arch}__{shape}__{mesh_name}{v}.json".replace("/", "_")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--out", default=os.path.join("results", "dryrun_torch"))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-donate", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if args.mesh in ("pod1", "both"):
        meshes.append(("pod1", mesh_lib.make_production_mesh()))
    if args.mesh in ("pod2", "both"):
        meshes.append(("pod2",
                       mesh_lib.make_production_mesh(multi_pod=True)))

    if args.all:
        cells = [(a, s) for a, s, ok, _ in configs.all_cells() if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        for mesh_name, mesh in meshes:
            fname = os.path.join(
                args.out, cell_filename(arch, shape, mesh_name,
                                        args.variant))
            if os.path.exists(fname) and not args.force:
                print(f"[skip] {fname} exists")
                continue
            print(f"[lower] {arch} x {shape} x {mesh_name} "
                  f"variant={args.variant!r} ...", flush=True)
            try:
                rec = lower_cell(arch, shape, mesh, variant=args.variant,
                                 donate=not args.no_donate)
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                ratio = rec["flops_global"] / rec["model_flops_global"]
                print(f"[ok] flops/dev(even)="
                      f"{rec['flops_per_device_even_split']:.3e} "
                      f"flops/model={ratio:.3f} "
                      f"coll={rec['collectives']['bytes_total']:.3e}B "
                      f"trace={rec['trace_s']}s", flush=True)
            except Exception as e:   # noqa: BLE001 - record and continue
                failures.append((arch, shape, mesh_name, str(e)))
                print(f"[FAIL] {arch} x {shape} x {mesh_name}: {e}")
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nAll requested cells traced and checked.")


if __name__ == "__main__":
    main()
