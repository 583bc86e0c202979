"""The port's dry run (`repro_torch.launch.dryrun`, `configs.registry`'s
cells and input specs, `launch.mesh`'s production meshes) held against
the JAX package's.

  * `all_cells` and every applicable cell's `input_specs` equal JAX's in
    shape and dtype (decode caches mapped to the port's flat per-layer
    layout: layer i is the JAX cache of pattern position i % P at
    superblock i // P);
  * for every applicable (arch, shape) cell on both production meshes the
    six analytic fields equal JAX's integers.  JAX's side is computed by
    its own `_tree_bytes_per_device`, `analytic_activation_bytes` and
    `model_flops` over `jax.eval_shape` trees and abstract meshes (a shim
    gives `_tree_bytes_per_device` the ``devices.shape`` it reads): no
    512 devices and no compile;
  * `_apply_variant` and `cell_filename` match JAX's;
  * the blocks traced at two short lengths and extrapolated equal a full
    trace at T 64 on the reduced configs (one superblock), and
    ``flops_global`` lies within [1.0, 1.6] x ``model_flops`` on two
    reduced configs (the trace counts the attention scores and the
    unembedding, which 6N / 2N leave out);
  * the analytic collectives of a tiny cell equal a hand count;
  * the CLI writes a record with JAX's keys, without importing JAX.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dry                     # noqa: E402
# The JAX dry run sets a 512-device XLA flag on import; it is read only
# when JAX's backend starts, so put the environment back at once.
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro import configs as j_configs                       # noqa: E402
from repro.distributed import sharding as j_shd              # noqa: E402
from repro.launch import steps as j_steps                    # noqa: E402
from repro.models import transformer as j_tr                 # noqa: E402
from repro_torch import configs as t_configs                 # noqa: E402
from repro_torch import tree as tree_lib                     # noqa: E402
from repro_torch.configs.registry import ShapeCell           # noqa: E402
from repro_torch.distributed import sharding as t_shd        # noqa: E402
from repro_torch.launch import dryrun as t_dry               # noqa: E402
from repro_torch.launch import mesh as t_mesh                # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
ANALYTIC = ("tokens_per_step", "state_bytes_per_device_analytic",
            "params_bytes_per_device", "cache_bytes_per_device",
            "activation_bytes_per_device_analytic", "model_flops_global")


class _MeshShim:
    """An abstract mesh with the ``devices.shape`` that JAX's
    `_tree_bytes_per_device` reads."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = types.SimpleNamespace(shape=tuple(shape))


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, fsdp=False):
    jc = j_configs.get(arch)
    if fsdp:
        jc = dataclasses.replace(jc, fsdp=True)
    return jc, jax.eval_shape(lambda: j_tr.init_params(
        jax.random.PRNGKey(0), jc))


def _jax_fields(arch, shape, mesh_name, fsdp=False):
    """JAX's six analytic fields of a cell, by its own functions."""
    jc, ps = _jax_params(arch, fsdp)
    cell = j_configs.SHAPES[shape]
    sizes, axes = MESHES[mesh_name]
    mesh, shim = j_shd.abstract_mesh(sizes, axes), _MeshShim(sizes, axes)
    pspec = j_shd.param_specs(jc, ps, mesh)
    if jc.fsdp:
        pspec = j_shd.fsdp_widen(pspec, ps, mesh)

    def tb(tree, specs):
        return j_dry._tree_bytes_per_device(tree, specs, shim)

    pb = tb(ps, pspec)
    if cell.kind == "train":
        opt = jax.eval_shape(j_steps.init_opt_state, ps)
        ospec = {"adam": j_shd.opt_state_specs(pspec, ps, mesh)}
        state, tokens = pb + tb(opt, ospec), cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        state, tokens = pb, cell.global_batch * cell.seq_len
    else:
        _, caches = j_configs.decode_inputs(jc, cell)
        cspec = tuple(j_shd.cache_spec_tree(jc, cs, mesh, cell.global_batch)
                      for cs in caches)
        state, tokens = pb + tb(caches, cspec), cell.global_batch
    return {"tokens_per_step": tokens,
            "state_bytes_per_device_analytic": state,
            "params_bytes_per_device": pb,
            "cache_bytes_per_device": max(state - pb, 0)
            if cell.kind == "decode" else 0,
            "activation_bytes_per_device_analytic":
                j_dry.analytic_activation_bytes(jc, cell, shim),
            "model_flops_global": j_steps.model_flops(jc, ps, cell.kind,
                                                      tokens)}


def _port_fields(cfg, shape, mesh_name):
    cell = t_configs.SHAPES[shape]
    mesh = t_shd.abstract_mesh(*MESHES[mesh_name])
    return t_dry.analytic_fields(cfg, cell, mesh,
                                 t_dry.build_cell(cfg, cell, mesh))


def test_all_cells_match_jax():
    assert list(t_configs.all_cells()) == list(j_configs.all_cells())


@pytest.mark.parametrize("arch", t_configs.list_archs())
def test_input_specs_match_jax(arch):
    jc = j_configs.get(arch)
    n_pattern = len(jc.pattern)
    for _, shape, ok, _ in (c for c in j_configs.all_cells() if c[0] == arch):
        if not ok:
            with pytest.raises(ValueError):
                t_configs.input_specs(arch, shape)
            continue
        want, got = j_configs.input_specs(arch, shape), \
            t_configs.input_specs(arch, shape)
        if isinstance(want, dict):
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert got[k].device.type == "meta"
                assert _dtype(got[k]) == _dtype(want[k]), k
            continue
        (want_io, want_caches), (got_io, got_caches) = want, got
        assert {k: (tuple(v.shape), _dtype(v)) for k, v in got_io.items()} \
            == {k: (tuple(v.shape), _dtype(v)) for k, v in want_io.items()}
        n_sb = jax.tree_util.tree_leaves(want_caches[0])[0].shape[0]
        assert len(got_caches) == n_sb * n_pattern
        for i, layer in enumerate(got_caches):
            stacked = want_caches[i % n_pattern]
            assert set(layer) == set(stacked)
            for k, leaf in layer.items():
                assert tuple(leaf.shape) == tuple(stacked[k].shape)[1:], \
                    (shape, i, k)
                assert _dtype(leaf) == _dtype(stacked[k]), (shape, i, k)


@pytest.mark.parametrize("arch", t_configs.list_archs())
def test_analytic_fields_match_jax(arch):
    cfg = t_configs.get(arch)
    for _, shape, ok, _ in (c for c in t_configs.all_cells() if c[0] == arch):
        if not ok:
            continue
        for mesh_name in MESHES:
            got = _port_fields(cfg, shape, mesh_name)
            assert got == _jax_fields(arch, shape, mesh_name), \
                (shape, mesh_name)


def test_fsdp_variant_matches_jax():
    """FSDP-widened params (the ``fsdp=1`` variant), where the port deals
    the layers of an unsplittable leaf over the data ranks."""
    for arch in ("qwen2.5-32b", "mixtral-8x7b", "recurrentgemma-2b"):
        cfg = t_dry._apply_variant(t_configs.get(arch), "fsdp=1")
        for shape in ("prefill_32k", "decode_32k"):
            for mesh_name in MESHES:
                assert _port_fields(cfg, shape, mesh_name) == _jax_fields(
                    arch, shape, mesh_name, fsdp=True), (arch, shape)


def test_apply_variant_and_cell_filename_match_jax():
    for variant in ("", "remat=1", "remat=0,fsdp=1", "window=512",
                    "dtype=float32,bf16_reduce=1"):
        want = j_dry._apply_variant(j_configs.get("h2o-danube-1.8b"),
                                    variant)
        got = t_dry._apply_variant(t_configs.get("h2o-danube-1.8b"), variant)
        for f in dataclasses.fields(got):
            if f.name != "moe":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        for arch, shape, mesh in (("qwen2.5-32b", "train_4k", "pod1"),
                                  ("a/b", "decode_32k", "pod2")):
            assert t_dry.cell_filename(arch, shape, mesh, variant) == \
                j_dry.cell_filename(arch, shape, mesh, variant)


def test_production_meshes():
    pod1 = t_mesh.make_production_mesh()
    pod2 = t_mesh.make_production_mesh(multi_pod=True)
    assert (pod1.axis_sizes, pod1.axis_names) == ((16, 16), ("data", "model"))
    assert (pod2.axis_sizes, pod2.axis_names) == \
        ((2, 16, 16), ("pod", "data", "model"))
    dbg = t_mesh.make_debug_mesh(multi_pod=True, model=4, data=3)
    assert (dbg.axis_sizes, dbg.axis_names) == \
        ((2, 3, 4), ("pod", "data", "model"))


def _traced(arch, kind, remat=False, full=True, superblocks=1):
    """A reduced config of ``superblocks`` superblocks, a (2, 64) cell:
    (the full trace's FLOPs by op or None, `trace_flops`'s, the blocks it
    extrapolated, model_flops)."""
    from torch.utils.flop_counter import FlopCounterMode
    base = t_configs.get(arch)
    cfg = dataclasses.replace(
        base.reduced(n_layers=superblocks * len(base.pattern)), remat=remat)
    cell = ShapeCell("t", 64, 2, kind)
    mesh = t_shd.abstract_mesh((1, 1), ("data", "model"))
    built = t_dry.build_cell(cfg, cell, mesh)
    counts = None
    if full:
        with FlopCounterMode(display=False) as fc:
            built["step_fn"](*built["args"])
        counts = {str(k): int(v)
                  for k, v in fc.get_flop_counts()["Global"].items()}
    by_op, extrapolated = t_dry.trace_flops(
        built["step_fn"], built["args"], cfg, kind, 2, 64,
        cfg.kv_cache_len(64))
    mflops = t_dry.steps_lib.model_flops(cfg, built["params"], kind,
                                         built["tokens"])
    return counts, by_op, extrapolated, mflops


@pytest.mark.parametrize("arch,kind,remat", [
    ("xlstm-1.3b", "prefill", False), ("xlstm-1.3b", "train", False),
    ("recurrentgemma-2b", "train", True),
    ("recurrentgemma-2b", "prefill", False)])
def test_extrapolated_blocks_equal_a_full_trace(arch, kind, remat):
    full, by_op, extrapolated, _ = _traced(arch, kind, remat)
    assert extrapolated, "no block was extrapolated"
    assert by_op == full


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b"])
def test_flops_global_against_model_flops(arch):
    for kind in ("train", "prefill"):
        _, by_op, _, mflops = _traced(arch, kind, full=False,
                                      superblocks=2)
        assert 1.0 <= sum(by_op.values()) / mflops <= 1.6, kind


def test_collectives_hand_computed():
    """Danube reduced (bf16 weights), train, 4 x 8 tokens, a 2 x 2
    (data, model) mesh, no FSDP: each leaf's gradient all-reduced over
    the 2 data ranks (2 * (2-1)/2 = 1 x its bytes a device) and four
    activation all-reduces per block over the 2 model ranks."""
    cfg = dataclasses.replace(t_configs.get("h2o-danube-1.8b").reduced(),
                              dtype="bfloat16")
    cell = ShapeCell("t", 8, 4, "train")
    mesh = t_mesh.make_debug_mesh(model=2, data=2)
    built = t_dry.build_cell(cfg, cell, mesh)
    coll = t_dry.analytic_collectives(cfg, cell, mesh, built["params"],
                                      built["pspec_base"], built["pspec"])
    # d 64, 4 heads / 1 kv head of 16, d_ff 128, 2 layers, padded vocab
    # 256: embed (256, 64) and unembed (64, 256) split over model (16 KiB
    # a device each); per layer two (64,) norms whole (128 B each), wq
    # (64, 64) and wo 4 KiB a device, wk and wv (64, 16) 1 KiB, w_up,
    # w_gate and w_down (64 x 128) 8 KiB; the final norm 128 B.
    layer = 2 * 128 + 4096 * 2 + 1024 * 2 + 8192 * 3
    grads = 2 * 16384 + 2 * layer + 128
    # activations: 2 rows of 8 tokens a data rank, 64 wide, bf16 = 2 KiB,
    # 2 * (2-1)/2 = 1 x, 4 per block, 2 blocks
    acts = 4 * 2 * 2048
    assert coll["source"] == "analytic"
    assert coll["by_kind"] == {"all-reduce": grads + acts}
    assert coll["bytes_total"] == grads + acts
    assert coll["by_group_size"] == {"2": grads + acts}
    n_leaves = len(tree_lib.leaves(built["params"]))
    assert coll["op_count"] == n_leaves + 8
    assert coll["top_ops"][0][:3] == [16384, "all-reduce", 2]


def test_cli_writes_a_record_with_jax_keys_without_jax(tmp_path):
    code = (
        "import sys, json\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'h2o-danube-1.8b', '--shape', 'decode_32k',"
        f" '--mesh', 'both', '--out', {str(tmp_path)!r}])\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    for mesh_name in MESHES:
        path = tmp_path / t_dry.cell_filename("h2o-danube-1.8b",
                                              "decode_32k", mesh_name)
        rec = json.loads(path.read_text())
        xla_only = {"hlo_flops_per_device", "hlo_bytes_per_device",
                    "cost_analysis_keys", "lower_s", "compile_s"}
        jax_keys = {"arch", "shape", "variant", "mesh", "axes", "n_devices",
                    "kind", "memory_analysis", "collectives",
                    *ANALYTIC} | xla_only
        assert jax_keys - xla_only <= set(rec)
        assert set(rec["memory_analysis"]) >= {
            "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
        assert rec["memory_analysis"]["temp_bytes"] is None
        assert set(rec["collectives"]) >= {"bytes_total", "by_kind",
                                           "by_group_size", "op_count",
                                           "top_ops"}
        assert rec["flops_global"] > 0
        assert rec["flops_per_device_even_split"] == \
            rec["flops_global"] / rec["n_devices"]
        want = _jax_fields("h2o-danube-1.8b", "decode_32k", mesh_name)
        assert {k: rec[k] for k in ANALYTIC} == want
