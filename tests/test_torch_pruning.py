"""Head-pruned variants and grouped serving in the port, held against the
JAX package: the pruning helpers on the same inputs, the registry's
masks, the pruned init against the dense one, the pruned model against
its zero-padded dense oracle, and the served logits of grouped and pruned
models against the JAX forward on JAX's weights.

Tolerances: pruning slices and stacks are copies, so int8 codes, scales
and float rows are compared for equality.  The pruned and zero-padded
dense schedules add the same terms, the dense one with extra exact zeros
in another summation order: within 1e-6 of the logit scale.  Served
logits as in tests/test_torch_model.py: float within 1e-4 of the logit
scale (fp32 reassociation); int8 at the same frozen scales with equal
argmax and within 2% of the logit scale (a one-LSB requant flip moves a
logit by about one activation scale times a weight)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as j_quant
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

PRUNED = ("vit_edge_p", "deit_t_p", "swin_t_p")


def _np(tree):
    """A JAX leaf or QTensor as numpy (values, scale) for comparison."""
    if hasattr(tree, "values") and hasattr(tree, "scale"):
        return np.asarray(tree.values), np.asarray(tree.scale)
    return (np.asarray(tree),)


def _tn(leaf):
    if isinstance(leaf, t_quant.QTensor):
        return leaf.values.numpy(), leaf.scale.numpy()
    return (leaf.numpy(),)


def _assert_same(got, want, what):
    for g, w in zip(_tn(got), _np(want)):
        np.testing.assert_array_equal(g, w, err_msg=what)


def _block(seed=0, h=4, d=32, dh=8):
    rng = np.random.default_rng(seed)
    f = {k: (rng.standard_normal((h, d, dh)) * d ** -0.5).astype(np.float32)
         for k in ("wq", "wk", "wv")}
    f["w_msa"] = (rng.standard_normal((h * dh, d)) * 0.2).astype(np.float32)
    f["rel_bias"] = rng.standard_normal((49, h)).astype(np.float32)
    f["ln1_w"] = np.ones(d, np.float32)
    return f


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("row", [(1, 0, 1, 1), (0, 0, 1, 0), (1, 1, 1, 1)])
def test_pruning_helpers_match_jax(row, quantized):
    f = _block()
    j_bp = {k: jnp.asarray(v) for k, v in f.items()}
    if quantized:
        j_bp = j_quant.quantize_vision_params(j_bp)
    t_bp = params_from_numpy(j_bp)
    keep = tuple(i for i, v in enumerate(row) if v)
    _assert_same(t_quant.slice_head_stack(t_bp["wq"], keep),
                 j_quant.slice_head_stack(j_bp["wq"], keep), "slice wq")
    _assert_same(t_quant.slice_concat_rows(t_bp["w_msa"], keep, 4),
                 j_quant.slice_concat_rows(j_bp["w_msa"], keep, 4), "rows")
    t_p = t_quant.prune_block_heads(t_bp, row)
    j_p = j_quant.prune_block_heads(j_bp, row)
    t_e = t_quant.expand_block_heads(t_p, row)
    j_e = j_quant.expand_block_heads(j_p, row)
    for k in j_bp:
        _assert_same(t_p[k], j_p[k], f"prune {k}")
        _assert_same(t_e[k], j_e[k], f"expand {k}")
    if quantized:
        _assert_same(t_quant.stack_qtensors([t_p["wq"], t_p["wk"]]),
                     j_quant.stack_qtensors([j_p["wq"], j_p["wk"]]), "stack")


def test_registry_masks_match_jax():
    for name in ("vit_edge", "deit_t", "swin_t"):
        for full in (False, True):
            t_cfg = t_reg.build_cfg(name, full=full)
            j_cfg = j_reg.build_cfg(name, full=full)
            assert t_reg.ragged_head_mask(t_cfg) == \
                j_reg.ragged_head_mask(j_cfg)
            for k in (1, 2, 5):
                assert t_reg.uniform_head_mask(t_cfg, k) == \
                    j_reg.uniform_head_mask(j_cfg, k)
            assert t_reg.build_cfg(name + "_p", full=full).head_mask == \
                j_reg.build_cfg(name + "_p", full=full).head_mask
    masked = t_reg.build_cfg("deit_t", head_mask=((1, 0, 1),) * 4)
    assert t_reg.make_schedule(masked).phases[1].heads == 2


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tuple(tree.shape)


@pytest.mark.parametrize("name", PRUNED)
def test_pruned_init_has_the_jax_layout_and_the_dense_heads(name):
    for full in (False, True):
        cfg = t_reg.build_cfg(name, full=full)
        j_cfg = j_reg.build_cfg(name, full=full)
        got = dict(_leaves(t_reg.init_params(cfg, seed=0)))
        want = dict(_leaves(jax.eval_shape(
            lambda: j_reg.init_params(jax.random.PRNGKey(0), j_cfg))))
        assert got == want
    cfg = t_reg.build_cfg(name)
    pruned = t_reg.init_params(cfg, seed=3)
    dense = t_reg.init_params(dataclasses.replace(cfg, head_mask=None), 3)
    if "layers" in dense:
        pairs = zip(pruned["layers"], dense["layers"], cfg.head_mask)
    else:
        pairs = zip(*(sum((s["blocks"] for s in p["stages"]), [])
                      for p in (pruned, dense)),
                    sum(cfg.head_mask, ()))
    for p, d, row in pairs:
        keep = [i for i, v in enumerate(row) if v]
        assert torch.equal(p["wq"], d["wq"][keep])
        assert torch.equal(p["w_up"], d["w_up"])


def test_serve_config_head_mask_serves_the_pruned_model():
    mask = ((1, 0, 1), (0, 1, 1), (1, 1, 0), (0, 0, 1))
    server = t_serve.make_server("deit_t", t_serve.ServeConfig(
        buckets=(2,), head_mask=mask, device="cpu"))
    cfg = server.cfg
    assert [bp["wq"].shape[0] for bp in server.params["layers"]] == \
        [2, 2, 2, 1]
    assert [p.heads for p in t_reg.make_schedule(cfg).phases
            if p.kind == "layer"] == [2, 2, 2, 1]
    images = np.random.default_rng(0).standard_normal(
        (2, cfg.image, cfg.image, 3)).astype(np.float32)
    reqs = server.submit_many(images)
    server.run()
    want = t_reg.forward_fn(cfg)(
        server.params,
        t_vit.extract_patches(torch.from_numpy(images), cfg.patch), cfg)
    np.testing.assert_array_equal(np.stack([r.logits for r in reqs]),
                                  want.numpy())


@pytest.mark.parametrize("name", ["deit_t_p", "swin_t_p"])
def test_pruned_matches_the_expanded_dense_oracle(name):
    cfg = t_reg.build_cfg(name)
    dense_cfg = dataclasses.replace(cfg, head_mask=None)
    params = t_reg.init_params(cfg, seed=0)

    def expand(tree):
        out = dict(tree)
        if "layers" in tree:
            out["layers"] = [t_quant.expand_block_heads(bp, row) for bp, row
                             in zip(tree["layers"], cfg.head_mask)]
        else:
            out["stages"] = [dict(st, blocks=[
                t_quant.expand_block_heads(bp, row)
                for bp, row in zip(st["blocks"], cfg.head_mask[s_i])])
                for s_i, st in enumerate(tree["stages"])]
        return out

    images = np.random.default_rng(2).standard_normal(
        (2, cfg.image, cfg.image, 3)).astype(np.float32)
    patches = t_vit.extract_patches(torch.from_numpy(images), cfg.patch)
    fwd = t_reg.forward_fn(cfg)
    qparams = t_reg.quantize(params)
    cal = t_serve.calibrate(qparams, cfg, images, device="cpu", n_batches=1)
    for p, obs in ((params, None), (qparams, cal)):
        want = fwd(expand(p), patches, dense_cfg, observer=obs)
        got = fwd(p, patches, cfg, observer=obs)
        assert float((got - want).abs().max()) <= \
            1e-6 * float(want.abs().max())


# ---------------------------------------------------------------------------
# Served logits, port against JAX: grouped and pruned models
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(name: str):
    """JAX params and int8 params of ``name`` (reduced), 3 images, and the
    port's frozen calibration scales on them (the tests of
    tests/test_torch_model.py hold those against JAX's calibrator)."""
    cfg = j_reg.build_cfg(name)
    params = j_reg.init_params(jax.random.PRNGKey(0), cfg)
    qparams = j_reg.quantize(params)
    images = np.random.default_rng(7).standard_normal(
        (3, cfg.image, cfg.image, 3)).astype(np.float32)
    cal = t_serve.calibrate(params_from_numpy(qparams), t_reg.build_cfg(name),
                            images, device="cpu", n_batches=2)
    return params, qparams, cal, images


@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("name,group", [
    ("vit_edge", 3), ("vit_edge", 4), ("deit_t", 3), ("deit_t", 4),
    ("swin_t", 4), ("vit_edge_p", 4), ("deit_t_p", 4), ("swin_t_p", 4)])
def test_served_logits_match_jax(name, group, mode):
    params, qparams, cal, images = _setup(name)
    j_cfg = j_reg.build_cfg(name, fuse_group=group)
    j_patches = j_vit.extract_patches(jnp.asarray(images), j_cfg.patch)
    fwd = j_reg.forward_fn(j_cfg)
    if mode == "float":
        want = jax.jit(lambda p, x: fwd(p, x, j_cfg))(params, j_patches)
    else:
        j_cal = j_quant.Calibrator()
        j_cal.frozen = {k: jnp.asarray(v.numpy()) for k, v in
                        cal.frozen.items()}
        want = jax.jit(lambda p, x: fwd(p, x, j_cfg, observer=j_cal))(
            qparams, j_patches)
    want = np.asarray(want)
    server = t_serve.make_server(
        name, t_serve.ServeConfig(mode=mode, buckets=(1, 2), fuse_group=group,
                                  device="cpu"),
        params=params_from_numpy(params),
        qparams=params_from_numpy(qparams), calibrator=cal)
    reqs = server.submit_many(images)
    stats = server.run()
    got = np.stack([r.logits for r in reqs])
    assert stats["group_buckets"] == {"1": group, "2": group}
    scale = float(np.abs(want).max())
    if mode == "float":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, scale))
    else:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        assert np.abs(got - want).max() <= 0.02 * scale
