"""The port's vision sharding on the CPU, held against the JAX package:
the spec rules leaf by leaf on abstract meshes, the batch specs, bucket
rounding and mesh-shape grammar, the layer references with their model
axes on the same shards, and the sharded replay (`run_schedule_sharded`
on gloo ranks) against JAX's single-device `run_schedule`.

The ranks are one pool per module (`launch.mesh.start_world`, four CPU
ranks meeting through a file store); every mesh of the module is built
on its first ranks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import SPLIT, layer_with_axes, rank_coords
from repro.core import quant as j_quant
from repro.core import schedule as j_sched
from repro.distributed import sharding as j_shd
from repro.kernels import ref as j_ref
from repro.launch.mesh import parse_mesh_shape as j_parse
from repro.launch.vision_serve import round_buckets as j_round
from repro.models import vision_registry as j_vr
from repro.models import vit as j_vit
from repro_torch.core import schedule as t_sched
from repro_torch.core.quant import Calibrator, QTensor
from repro_torch.distributed import sharding as t_shd
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.vision_serve import calibrate, round_buckets
from repro_torch.models import vision_registry as t_vr
from repro_torch.models import vit as t_vit

MESHES = ((1, 2), (1, 3), (1, 4), (2, 2), (2, 4), (8, 1))
RANKS = 4


@pytest.fixture(scope="module")
def pool():
    world = t_mesh.start_world(RANKS, "cpu", timeout_s=120)
    yield world
    world.close()


# ---------------------------------------------------------------------------
# Spec rules (no ranks)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _port_trees(name: str):
    cfg = t_vr.build_cfg(name)
    params = t_vr.init_params(cfg, 0)
    return params, t_vr.quantize(params)


def _jax_shapes(tree):
    """The port tree's shapes as the JAX package's tree (ShapeDtypeStruct
    leaves, its QTensor for quantized leaves)."""
    if isinstance(tree, dict):
        return {k: _jax_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax_shapes(v) for v in tree]
    if isinstance(tree, QTensor):
        return j_quant.QTensor(_jax_shapes(tree.values),
                               _jax_shapes(tree.scale))
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _flat(specs, ranks, path=()):
    """{path: spec padded to its leaf's rank} over a JAX or port spec tree
    (``ranks`` is the port param tree, for the leaf ranks)."""
    out = {}
    if isinstance(specs, dict):
        for k, v in specs.items():
            out.update(_flat(v, ranks[k], path + (k,)))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            out.update(_flat(v, ranks[i], path + (i,)))
    elif isinstance(specs, (QTensor, j_quant.QTensor)):
        out.update(_flat(specs.values, ranks.values, path + ("values",)))
        out.update(_flat(specs.scale, ranks.scale, path + ("scale",)))
    else:
        spec = tuple(specs)
        out[path] = spec + (None,) * (ranks.dim() - len(spec))
    return out


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", t_vr.list_models())
def test_param_specs_match_jax(name, shape):
    """Every leaf of every registered model, float and int8, gets the
    reference's spec on every listed (data, model) mesh."""
    j_mesh = j_shd.abstract_mesh(shape, ("data", "model"))
    t_mesh_ = t_shd.abstract_mesh(shape, ("data", "model"))
    for tree in _port_trees(name):
        want = _flat(j_shd.vision_param_specs(_jax_shapes(tree), j_mesh),
                     tree)
        got = _flat(t_shd.vision_param_specs(tree, t_mesh_), tree)
        assert got == want, name
        assert not any("data" in s for s in got.values())


def test_ragged_pruned_blocks_shard_and_replicate():
    """deit_t_p keeps 3, 2 and 1 heads: at model 2 only the 2-head blocks
    shard their stacks and concat rows, while every block's MLP shards."""
    params, _ = _port_trees("deit_t_p")
    specs = t_shd.vision_param_specs(params,
                                     t_shd.abstract_mesh((1, 2),
                                                         ("data", "model")))
    for bp, sp in zip(params["layers"], specs["layers"]):
        shards = bp["wq"].shape[0] % 2 == 0
        assert (sp["wq"][0] == "model") == shards
        assert (sp["w_msa"][0] == "model") == shards
        assert sp["w_up"] == (None, "model") and sp["w_down"][0] == "model"
        assert sp["ln1_w"] == (None,)


def test_batch_specs_buckets_and_mesh_shapes():
    """The cases of the reference's own tests, through both packages."""
    for mesh in (t_shd.abstract_mesh((4,), ("data",)),
                 j_shd.abstract_mesh((4,), ("data",))):
        assert tuple(t_shd.vision_batch_spec(8, mesh)) == ("data",)
        assert tuple(t_shd.vision_batch_spec(5, mesh)) == (None,)
    for b in (1, 2, 4, 6, 8):
        for mesh in ((4,), (2, 2), (1, 3)):
            names = ("data", "model")[:len(mesh)]
            assert tuple(t_shd.vision_batch_spec(
                b, t_shd.abstract_mesh(mesh, names))) in (
                tuple(j_shd.vision_batch_spec(
                    b, j_shd.abstract_mesh(mesh, names))), (None,))
    for buckets, dp in (((1, 2, 4, 8), 1), ((1, 2, 4, 8), 4),
                        ((1, 2, 4), 8), ((3, 5), 4), ((2, 4, 8), 2)):
        assert round_buckets(buckets, dp) == j_round(buckets, dp)
    assert round_buckets((3, 5), 4) == (4, 8)
    for text in ("4x2", "8", "2×4", (2, 4), "1x3"):
        assert t_mesh.parse_mesh_shape(text) == j_parse(text)
    for bad in ("abc", "0x4", "4x-2", "1x2x3"):
        with pytest.raises(ValueError):
            t_mesh.parse_mesh_shape(bad)


def test_meshes_need_enough_ranks(pool):
    assert t_mesh.make_vision_mesh(2, 2, "cpu").size == 4
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        t_mesh.make_vision_mesh(4, 2, "cpu")
    mesh = t_mesh.make_vision_mesh(1, 3, "cpu")
    assert (mesh.axis_names, mesh.axis_sizes) == (("data", "model"), (1, 3))
    assert t_mesh.make_vision_mesh(2, 1, "cpu").axis_names == ("data",)
    assert t_mesh.make_vision_mesh(1, 3, "cpu") is mesh
    assert t_mesh.per_rank(mesh, rank_coords, mesh) == [(0, 0), (0, 1),
                                                          (0, 2)]


# ---------------------------------------------------------------------------
# The layer references with model axes, on the same shards as JAX's
# ---------------------------------------------------------------------------


def _layer_operands(int8: bool, windowed: bool):
    """Whole operands of a 4-head layer (D 32, Dh 8, M 64): numpy."""
    rng = np.random.default_rng(7)
    b, n, d, h, dh, m = (4, 9, 32, 4, 8, 64)

    def f(*shape, s=0.2):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    x = f(b, n, d, s=1.0)
    bias = f(h, n, n) if windowed else None
    mask = None
    if windowed:                    # no row masked whole: keep the diagonal
        mask = np.where(rng.random((2, n, n)) < 0.2, -1e30, 0.0).astype(
            np.float32)
        mask[:, np.arange(n), np.arange(n)] = 0.0
    ln = [1.0 + f(d), f(d), 1.0 + f(d), f(d)]
    if not int8:
        return (x, f(h, d, dh), f(h, d, dh), f(h, d, dh), f(h * dh, d),
                *ln, f(d, m), f(m), f(m, d), f(d), bias, mask)

    def q(*shape):
        return rng.integers(-127, 128, shape).astype(np.int8)

    def s(*shape):
        return (rng.random(shape) * 0.01 + 0.001).astype(np.float32)

    return (x, q(h, d, dh), q(h, d, dh), q(h, d, dh), q(h * dh, d),
            q(d, m), q(m, d), np.array([0.03, 0.02, 0.03, 0.05], np.float32),
            s(h, dh), s(h, dh), s(h, dh), s(d), s(m), s(d), *ln, f(m), f(d),
            bias, mask)


@pytest.mark.parametrize("windowed", [False, True], ids=["global", "window"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_layer_refs_with_axes_match_jax(pool, int8, windowed):
    """The port's layer reference on two ranks' shards, all-reduced over
    their model group, against JAX's on the same shards (its psum over a
    vmapped axis), and against the whole layer."""
    args = _layer_operands(int8, windowed)
    split = SPLIT[int8]
    model = 2

    def stacked(i, a):
        if a is None or i not in split:
            return a
        return np.stack(np.split(a, model, axis=split[i]))

    jfn = j_ref.vita_layer_int8_ref if int8 else j_ref.vita_layer_ref
    in_axes = tuple(0 if (a is not None and i in split) else None
                    for i, a in enumerate(args))
    want = np.asarray(jax.vmap(
        lambda *a: jfn(*a, msa_axis="m", mlp_axis="m"), in_axes=in_axes,
        axis_name="m")(*[stacked(i, a) for i, a in enumerate(args)]))[0]
    whole = np.asarray(jfn(*args))
    mesh = t_mesh.make_vision_mesh(1, model, "cpu")
    t_args = [None if a is None else torch.from_numpy(a) for a in args]
    got = mesh.call(layer_with_axes, mesh, int8, t_args).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(want - whole).max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# The sharded replay against JAX's single-device replay
# ---------------------------------------------------------------------------


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if isinstance(tree, QTensor):
        return j_quant.QTensor(jnp.asarray(tree.values.numpy()),
                               jnp.asarray(tree.scale.numpy()))
    return jnp.asarray(tree.numpy())


@functools.lru_cache(maxsize=None)
def _case(name: str, fused: bool, group: int, batch: int = 4):
    """Port params (seed 0), int8 params and frozen scales, the images,
    and JAX's single-device logits for both modes on the same weights
    (its XLA path: the reference's own 2-D fused path)."""
    cfg = t_vr.build_cfg(name, fused=fused, fuse_group=group)
    params = t_vr.init_params(cfg, 0)
    qparams = t_vr.quantize(params)
    images = np.random.default_rng(5).standard_normal(
        (batch, cfg.image, cfg.image, 3)).astype(np.float32)
    cal = calibrate(qparams, cfg, images, device="cpu", n_batches=1)
    j_cfg = j_vr.build_cfg(name, fused=fused, fuse_group=group,
                           backend="xla")
    sched = j_vr.make_schedule(j_cfg)
    j_cal = j_quant.Calibrator()
    j_cal.frozen = {k: jnp.asarray(v.numpy()) for k, v in cal.frozen.items()}
    x = j_vit.extract_patches(jnp.asarray(images), cfg.patch)
    want_f = jax.jit(lambda p, x: j_sched.run_schedule(sched, p, x))(
        _to_jax(params), x)
    want_i = jax.jit(lambda p, x: j_sched.run_schedule(
        sched, p, x, observer=j_cal))(_to_jax(qparams), x)
    return (cfg, params, qparams, cal, images, np.asarray(want_f),
            np.asarray(want_i))


VARIANTS = {"fused": (True, 1), "unfused": (False, 1), "grouped": (True, 2)}
REPLAYS = (("vit_edge", "2x2"), ("vit_edge", "4x1"), ("deit_t", "1x3"),
           ("swin_t", "1x2"), ("tnt_s", "1x2"), ("deit_t_p", "1x2"))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name,shape", REPLAYS)
def test_sharded_replay_matches_jax(pool, name, shape, variant):
    """Float within 1e-5 of the logit scale; int8 with the same argmax
    and within the port's int8 end-to-end bound (2% of the scale)."""
    fused, group = VARIANTS[variant]
    cfg, params, qparams, cal, images, want_f, want_i = _case(name, fused,
                                                              group)
    mesh = t_mesh.make_vision_mesh(*t_mesh.parse_mesh_shape(shape), "cpu")
    sched = t_vr.make_schedule(cfg)
    x = t_vit.extract_patches(torch.from_numpy(images), cfg.patch)
    got_f = t_sched.run_schedule_sharded(sched, params, x, mesh).numpy()
    got_i = t_sched.run_schedule_sharded(sched, qparams, x, mesh,
                                         observer=cal).numpy()
    assert got_f.shape == want_f.shape == (4, cfg.n_classes)
    assert np.abs(got_f - want_f).max() <= 1e-5 * np.abs(want_f).max()
    np.testing.assert_array_equal(got_i.argmax(1), want_i.argmax(1))
    assert np.abs(got_i - want_i).max() <= 0.02 * np.abs(want_i).max()


def test_non_divisible_batch_replicates(pool):
    """3 images on a 4-rank data mesh: every rank replays every row (the
    replication fallback), and the logits still equal JAX's."""
    cfg, params, _, _, images, _, _ = _case("vit_edge", True, 1)
    mesh = t_mesh.make_vision_mesh(4, 1, "cpu")
    x = t_vit.extract_patches(torch.from_numpy(images[:3]), cfg.patch)
    assert t_shd.vision_batch_spec(3, mesh) == (None,)
    got = t_sched.run_schedule_sharded(t_vr.make_schedule(cfg), params, x,
                                       mesh).numpy()
    want = t_sched.run_schedule(t_vr.make_schedule(cfg), params, x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="frozen"):
        t_sched.run_schedule_sharded(t_vr.make_schedule(cfg), params, x,
                                     mesh, observer=Calibrator())


def test_sharded_replay_matches_jax_sharded(pool):
    """Where JAX sees enough devices, also against JAX's own
    `run_schedule_sharded` on the same (1, 2) mesh."""
    if jax.device_count() < 2:
        pytest.skip("JAX sees one device (run under XLA_FLAGS="
                    "--xla_force_host_platform_device_count=2)")
    from repro.launch.mesh import make_vision_mesh
    cfg, params, _, _, images, want_f, _ = _case("deit_t", True, 1)
    j_cfg = j_vr.build_cfg("deit_t", backend="xla")
    x = j_vit.extract_patches(jnp.asarray(images), cfg.patch)
    want = np.asarray(j_sched.run_schedule_sharded(
        j_vr.make_schedule(j_cfg), _to_jax(params), x,
        make_vision_mesh(1, 2)))
    got = t_sched.run_schedule_sharded(
        t_vr.make_schedule(cfg), params,
        t_vit.extract_patches(torch.from_numpy(images), cfg.patch),
        t_mesh.make_vision_mesh(1, 2, "cpu")).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
