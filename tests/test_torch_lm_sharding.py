"""The port's LM sharding rules (`repro_torch.distributed.sharding`) held
against the JAX package's on its test meshes (`tests/test_sharding.py`:
the 16 x 16 (data, model) pod and the 2 x 16 x 16 (pod, data, model)
multi-pod mesh), for all ten configs at full size, shapes only (meta
tensors, no weights):

  * `param_specs`: a leaf under ``layers[i]`` gets the JAX spec of its
    stacked leaf without the leading None, every other leaf the JAX spec;
  * `train_batch_specs` and `cache_spec_tree` (the per-layer caches
    against the stacked ones, likewise);
  * `fsdp_widen` and `opt_state_specs`: the same, except where the JAX
    package puts ``data`` on the stacked dim (the data axis divides the
    superblock count), which a per-layer leaf does not have: there the
    port's leaf has ``data`` on its first unsharded dim that the axis
    divides (the reference's own rule on the unstacked leaf).

The rules also run on the port's process meshes (`launch.mesh`)."""

import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.distributed import sharding as j_shd
from repro.models import transformer as j_tr
from repro_torch import configs as t_configs
from repro_torch import tree as tree_lib
from repro_torch.distributed import sharding as t_shd
from repro_torch.launch import mesh as t_mesh

ARCHS = t_configs.list_archs()
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(multi_pod):
    shape, axes = MESHES[multi_pod]
    return j_shd.abstract_mesh(shape, axes), t_shd.abstract_mesh(shape, axes)


def _meta(shape_tree):
    """The JAX shape tree (``layers`` / caches stacked per pattern
    position) as the port's tree of meta tensors, unstacked per layer."""
    def leaf(s, drop=0):
        return torch.empty(tuple(s.shape)[drop:], device="meta")

    def unstack(stacked):
        n = jax.tree_util.tree_leaves(stacked[0])[0].shape[0]
        return [jax.tree_util.tree_map(lambda s: leaf(s, 1), stacked[p])
                for _ in range(n) for p in range(len(stacked))]

    if isinstance(shape_tree, tuple):            # caches
        return unstack(shape_tree)
    out = {k: jax.tree_util.tree_map(leaf, v) for k, v in shape_tree.items()
           if k != "layers"}
    out["layers"] = unstack(shape_tree["layers"])
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    jc, tc = j_configs.get(arch), t_configs.get(arch)
    pshape = jax.eval_shape(lambda: j_tr.init_params(
        jax.random.PRNGKey(0), jc))
    return jc, tc, pshape, _meta(pshape)


def _spec(p, ndim):
    spec = tuple(p)
    return spec + (None,) * (ndim - len(spec))


def _jax_at(tree, path, n_pattern):
    """The JAX tree's leaf that the port's ``path`` slices (and whether it
    is stacked)."""
    if path and path[0] == "layers":
        return tree_lib.at(tree["layers"][path[1] % n_pattern],
                           path[2:]), True
    return tree_lib.at(tree, path), False


def _flat_specs(specs):
    """{path: spec} of a port spec tree (spec tuples are its leaves)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out[path] = t
    walk(specs, ())
    return out


def _layers_widened(jax_spec, port_spec, base_spec, shape, dsize):
    """The port's widened spec of a layer leaf against the JAX one (module
    docstring): equal without the stacked entry, or, where JAX chose the
    stacked dim, the reference rule on the unstacked leaf."""
    if jax_spec[0] is None:
        return port_spec == jax_spec[1:]
    want = list(base_spec)
    for i, (dim, ax) in enumerate(zip(shape, base_spec)):
        if ax is None and dim % dsize == 0:
            want[i] = "data"
            break
    return port_spec == tuple(want)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, multi_pod):
    jc, tc, pshape, meta = _shapes(arch)
    j_mesh, t_mesh_ = _meshes(multi_pod)
    j_specs = j_shd.param_specs(jc, pshape, j_mesh)
    t_specs = _flat_specs(t_shd.param_specs(tc, meta, t_mesh_))
    n_sharded = 0
    for path, leaf in tree_lib.leaves_with_path(meta):
        j_spec, stacked = _jax_at(j_specs, path, len(jc.pattern))
        want = _spec(j_spec, leaf.dim() + stacked)
        assert t_specs[path] == (want[1:] if stacked else want), path
        n_sharded += sum(a is not None for a in t_specs[path])
    assert n_sharded > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_batch_specs_match_jax(multi_pod):
    j_mesh, t_mesh_ = _meshes(multi_pod)
    for arch in ("h2o-danube-1.8b", "internvl2-26b", "hubert-xlarge"):
        jc, tc = j_configs.get(arch), t_configs.get(arch)
        for b in (256, 16, 6, 1):
            shapes = {"tokens": jax.ShapeDtypeStruct((b, 64), np.int32),
                      "labels": jax.ShapeDtypeStruct((b, 64), np.int32),
                      "patch_embeds": jax.ShapeDtypeStruct(
                          (b, 8, 32), np.float32)}
            want = j_shd.train_batch_specs(jc, shapes, j_mesh)
            got = t_shd.train_batch_specs(tc, shapes, t_mesh_)
            assert got == {k: _spec(v, len(shapes[k].shape))
                           for k, v in want.items()}


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if t_configs.get(a).supports_decode])
def test_cache_spec_tree_matches_jax(arch):
    jc, tc = j_configs.get(arch), t_configs.get(arch)
    for multi_pod in (False, True):
        j_mesh, t_mesh_ = _meshes(multi_pod)
        for batch in (32, 3):
            cshape = jax.eval_shape(lambda: j_tr.init_caches(jc, batch, 256))
            meta = _meta(cshape)
            want = j_shd.cache_spec_tree(jc, cshape, j_mesh, batch)
            got = _flat_specs(t_shd.cache_spec_tree(tc, meta, t_mesh_,
                                                    batch))
            for path, leaf in tree_lib.leaves_with_path(meta):
                j_spec = tree_lib.at(want[path[0] % len(jc.pattern)],
                                     path[1:])
                assert got[path] == _spec(j_spec, leaf.dim() + 1)[1:], path


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_widen_and_opt_state_specs_match_jax(arch):
    jc, tc, pshape, meta = _shapes(arch)
    for multi_pod in (False, True):
        j_mesh, t_mesh_ = _meshes(multi_pod)
        dsize = dict(zip(*reversed(MESHES[multi_pod])))["data"]
        j_base = j_shd.param_specs(jc, pshape, j_mesh)
        t_base = t_shd.param_specs(tc, meta, t_mesh_)
        flat_base = _flat_specs(t_base)
        for j_wide, t_wide in (
                (j_shd.fsdp_widen(j_base, pshape, j_mesh),
                 t_shd.fsdp_widen(t_base, meta, t_mesh_, cfg=tc)),
                (j_shd.opt_state_specs(j_base, pshape, j_mesh)["m"],
                 t_shd.opt_state_specs(t_base, meta, t_mesh_)["m"])):
            got = _flat_specs(t_wide)
            for path, leaf in tree_lib.leaves_with_path(meta):
                j_spec, stacked = _jax_at(j_wide, path, len(jc.pattern))
                want = _spec(j_spec, leaf.dim() + stacked)
                if not stacked:
                    assert got[path] == want, path
                else:
                    assert _layers_widened(want, got[path], flat_base[path],
                                           tuple(leaf.shape), dsize), \
                        (path, want, got[path])
    assert t_shd.opt_state_specs(t_base)["count"] == ()


def test_lm_rules_run_on_the_port_meshes():
    """The rules read only axis names and sizes: a `launch.mesh` process
    mesh gives what the abstract mesh of its shape gives."""
    _, tc, _, meta = _shapes("h2o-danube-1.8b")
    mesh = t_mesh.make_vision_mesh(1, 1, "cpu")
    assert t_shd.param_specs(tc, meta, mesh) == t_shd.param_specs(
        tc, meta, t_shd.abstract_mesh((1,), ("data",)))
    big = t_shd.abstract_mesh((4, 2), ("data", "model"))
    specs = t_shd.param_specs(tc, meta, big)
    assert specs["layers"][0]["mixer"]["wq"] == (None, "model")
    assert specs["layers"][0]["mlp"]["w_down"] == ("model", None)
    assert specs["embed"] == ("model", None)
