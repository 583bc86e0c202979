"""The port's quantization, schedule and model forward held against the JAX
package on the same weights (JAX's seeded init, carried across with
`repro_torch.convert.params_from_numpy`) and the same numpy images.

Tolerances: float logits within 1e-4 at a logit scale of about 1 (fp32
reassociation; the reference's own equal-math paths differ by ~5e-7);
int8 logits with JAX's frozen scales: equal argmax and max|dlogit| <=
0.02 * max|logit|, since a single-LSB requant flip at a rounding boundary
moves a logit by about one activation scale times a weight."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as j_sched
from repro.launch import vision_serve as j_serve
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.core import schedule as t_sched
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

MODELS = ("deit_t", "vit_edge")


@functools.lru_cache(maxsize=None)
def _setup(name: str):
    """JAX cfg/params/int8 params/frozen calibrator, and 3 images."""
    cfg = j_reg.build_cfg(name)
    params = j_reg.init_params(jax.random.PRNGKey(0), cfg)
    qparams = j_reg.quantize(params)
    images = np.random.default_rng(7).standard_normal(
        (3, cfg.image, cfg.image, 3)).astype(np.float32)
    cal = j_serve.calibrate(qparams, cfg, images, n_batches=2)
    return cfg, params, qparams, cal, images


def _qtensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _qtensors(v, path + (i,))
    elif hasattr(tree, "values") and hasattr(tree, "scale"):
        yield path, tree


@pytest.mark.parametrize("name", MODELS)
def test_quantize_vision_params_matches_jax_exactly(name):
    _, params, qparams, _, _ = _setup(name)
    got = dict(_qtensors(t_quant.quantize_vision_params(
        params_from_numpy(params))))
    want = dict(_qtensors(qparams))
    assert got.keys() == want.keys() and len(want) == 2 + 6 * len(
        params["layers"])
    for path, q in want.items():
        np.testing.assert_array_equal(got[path].values.numpy(),
                                      np.asarray(q.values), err_msg=str(path))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(q.scale), err_msg=str(path))


@pytest.mark.parametrize("name", MODELS)
def test_calibrator_scales_match_jax(name):
    cfg, _, qparams, cal, images = _setup(name)
    t_cal = t_serve.calibrate(params_from_numpy(qparams),
                              t_reg.build_cfg(name), images, device="cpu",
                              n_batches=2)
    assert t_cal.frozen.keys() == cal.frozen.keys()
    for k, v in cal.frozen.items():
        np.testing.assert_allclose(float(t_cal.frozen[k]), float(v),
                                   rtol=1e-5, err_msg=k)


def test_quant_helpers():
    x = torch.tensor([[-2.5, 0.5], [1.5, 3.0]])
    s = t_quant.amax_scale(x)
    assert float(s) == np.float32(3.0) / np.float32(127.0)
    q = t_quant.quantize(x, s)
    assert q.values.dtype == torch.int8
    # round half to even at the .5 boundaries, as jnp.round does
    np.testing.assert_array_equal(
        t_quant.quantize(torch.tensor([0.5, 1.5, 2.5, -0.5]),
                         torch.tensor(1.0)).values.numpy(), [0, 2, 2, 0])
    assert t_quant.ptq_tolerance(2.0) == pytest.approx(0.25)
    cal = t_quant.Calibrator()
    with pytest.raises(RuntimeError):
        cal.to("cpu")
    cal.observe("a", x)
    cal.freeze()
    moved = cal.to("cpu")
    assert moved.frozen["a"].dtype == torch.float32
    assert float(moved.observe("a", x)) == float(cal.frozen["a"])


def _phase_rows(sched, fields):
    return [tuple(getattr(p, f) for f in fields) for p in sched.phases]


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("full", [False, True])
def test_schedule_matches_jax(name, full):
    j_cfg = j_reg.build_cfg(name, full=full)
    t_cfg = t_reg.build_cfg(name, full=full)
    fields = ("kind", "path", "site", "grid", "heads", "pos_embed")
    unfused_j = j_sched.compile_schedule(j_vit.to_spec(j_cfg),
                                         n_classes=j_cfg.n_classes,
                                         hierarchical=False)
    unfused_t = t_sched.compile_schedule(t_vit.to_spec(t_cfg),
                                         n_classes=t_cfg.n_classes)
    assert _phase_rows(unfused_t, fields) == _phase_rows(unfused_j, fields)
    fused_t = t_vit.schedule(t_cfg)
    assert _phase_rows(fused_t, fields) == \
        _phase_rows(j_reg.make_schedule(j_cfg), fields)
    assert fused_t.counts() == {"embed": 1, "layer": t_cfg.layers, "head": 1}
    assert t_sched.fuse_schedule(fused_t) == fused_t      # idempotent
    grouped_t = t_sched.fuse_schedule(unfused_t, group_size=2)
    grouped_j = j_sched.fuse_schedule(unfused_j, group_size=2)
    assert _phase_rows(grouped_t, fields) == _phase_rows(grouped_j, fields)
    assert [tuple(m.site for m in p.members) for p in grouped_t.phases] == \
        [tuple(m.site for m in p.members) for p in grouped_j.phases]
    assert grouped_t.counts()["layer_group"] == t_cfg.layers // 2


def test_extract_patches_matches_jax():
    images = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_vit.extract_patches(torch.from_numpy(images), 8).numpy(),
        np.asarray(j_vit.extract_patches(jnp.asarray(images), 8)))


@pytest.mark.parametrize("name", MODELS)
def test_forward_float_matches_jax(name):
    cfg, params, _, _, images = _setup(name)
    want = np.asarray(j_vit.forward(
        params, j_vit.extract_patches(jnp.asarray(images), cfg.patch), cfg))
    t_cfg = t_reg.build_cfg(name)
    got = t_vit.forward(params_from_numpy(params), t_vit.extract_patches(
        torch.from_numpy(images), t_cfg.patch), t_cfg).numpy()
    assert np.abs(want).max() < 5.0          # logit scale of about 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_forward_int8_matches_jax(name):
    cfg, _, qparams, cal, images = _setup(name)
    want = np.asarray(j_vit.forward(
        qparams, j_vit.extract_patches(jnp.asarray(images), cfg.patch), cfg,
        observer=cal))
    t_cfg = t_reg.build_cfg(name)
    got = t_vit.forward(
        params_from_numpy(qparams),
        t_vit.extract_patches(torch.from_numpy(images), t_cfg.patch), t_cfg,
        observer=calibrator_from_scales(cal.frozen)).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_init_params_is_seeded_and_device_independent():
    cfg = t_reg.build_cfg("vit_edge")
    a = t_vit.init_params(cfg, seed=3)
    b = t_vit.init_params(cfg, seed=3)
    c = t_vit.init_params(cfg, seed=4)
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    assert not torch.equal(a["head"], c["head"])
    assert a["layers"][0]["wq"].shape == (cfg.heads, cfg.dim, cfg.head_dim)
    assert a["pos_embed"].shape == (cfg.tokens, cfg.dim)
