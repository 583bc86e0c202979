"""The port's generic tree PTQ (`repro_torch.core.quant`) held against the
JAX package's `repro.core.quant` on the same numbers.

  * `quantize_per_tensor`, with and without a percentile (JAX's linear
    interpolation), gives JAX's int8 codes and scale exactly, in float32
    and bfloat16 (a percentile over axes: within 1 ulp);
  * `quantized_linear`'s int32 accumulator is JAX's exactly, and its
    output too (0 ulp: the rescale runs outside the kernel in JAX's
    order, acc * (act_scale * w_scale) + bias);
  * `quantize_params` / `dequantize_params` on each of the ten reduced LM
    trees give JAX's codes and scales leaf for leaf under the stacked-leaf
    rule (a layer is superblock i // P of its pattern position's JAX
    stack; the scale is the stack's, shared);
  * `vit.quantize_vit`, `swin.quantize_swin`, `vit.deit_s`,
    `layers.layer_norm` and `quant_error_bound` match JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import quant as j_quant
from repro.models import layers as j_layers
from repro.models import swin as j_swin
from repro.models import transformer as j_tr
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch import configs as t_configs
from repro_torch import tree as tree_lib
from repro_torch.convert import lm_params_from_numpy, params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.models import layers as t_layers
from repro_torch.models import swin as t_swin
from repro_torch.models import vit as t_vit

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == \
        jnp.bfloat16 else np.asarray(x)


def _t(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pct", [None, 99.9, 50.0, 100.0, 0.0, 37.5])
def test_quantize_per_tensor_matches_jax(pct, dtype):
    rng = np.random.default_rng(11)
    for shape in ((7,), (33, 65), (4, 50, 129)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        xt = torch.from_numpy(x).to(dtype)
        want = j_quant.quantize_per_tensor(jnp.asarray(x, JDT[dtype]),
                                           percentile=pct)
        got = t_quant.quantize_per_tensor(xt, percentile=pct)
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
        assert got.scale.dtype == torch.float32
        np.testing.assert_array_equal(_t(got.scale), _np(want.scale))
        assert got.shape == tuple(want.shape)


def test_amax_scale_percentile_over_axes_matches_jax():
    """Over axes, within 1 ulp: XLA's vectorised loops round the
    interpolation's sum one way or the other, shape by shape."""
    x = np.random.default_rng(2).standard_normal((5, 6, 7)).astype(
        np.float32)
    for axis in ((0,), (1, 2), (0, 2)):
        want = j_quant.amax_scale(jnp.asarray(x), axis=axis, percentile=90.0)
        got = t_quant.amax_scale(torch.from_numpy(x), dim=axis,
                                 percentile=90.0)
        assert got.shape == want.shape
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                        maxulp=1)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_quantized_linear_matches_jax(x_dtype, out_dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    act = np.float32(np.abs(x).max() / 127.0)
    wq_j = j_quant.quantize_per_channel(jnp.asarray(w))
    wq_t = t_quant.quantize_per_channel(torch.from_numpy(w))
    accs = {}

    def spy_j(xq, wv):
        accs["jax"] = j_quant.int8_matmul_ref(xq, wv)
        return accs["jax"]

    def spy_t(xq, wv):
        accs["port"] = t_quant._kernel_matmul(xq, wv)
        return accs["port"]

    want = j_quant.quantized_linear(
        jnp.asarray(x, JDT[x_dtype]), wq_j, jnp.asarray(bias),
        jnp.asarray(act), out_dtype=JDT[out_dtype], matmul=spy_j)
    got = t_quant.quantized_linear(
        torch.from_numpy(x).to(x_dtype), wq_t, torch.from_numpy(bias),
        torch.tensor(act), out_dtype=out_dtype, matmul=spy_t)
    assert accs["port"].dtype == torch.int32
    np.testing.assert_array_equal(accs["port"].numpy(),
                                  np.asarray(accs["jax"]))
    np.testing.assert_array_equal(_t(got), _np(want))
    # the default matmul (kernel 4's plain version here) gives the same
    again = t_quant.quantized_linear(
        torch.from_numpy(x).to(x_dtype), wq_t, torch.from_numpy(bias),
        torch.tensor(act), out_dtype=out_dtype)
    assert torch.equal(again, got)
    acc_ref = t_quant.int8_matmul_ref(
        torch.clamp(torch.round(torch.from_numpy(x).to(x_dtype).float()
                                / act), -127, 127).to(torch.int8),
        wq_t.values)
    np.testing.assert_array_equal(acc_ref.numpy(), np.asarray(accs["jax"]))


def _jax_stacked_leaf(tree, path, n_pattern):
    """JAX's leaf that the port's ``path`` slices, and the superblock."""
    if path[0] == "layers":
        node = tree["layers"][path[1] % n_pattern]
        for k in path[2:]:
            node = node[k]
        return node, path[1] // n_pattern
    node = tree
    for k in path:
        node = node[k]
    return node, None


@pytest.mark.parametrize("arch", t_configs.list_archs())
def test_quantize_params_matches_jax_on_the_lm_tree(arch):
    jc = j_configs.get(arch).reduced()
    tc = t_configs.get(arch).reduced()
    params = j_tr.init_params(jax.random.PRNGKey(0), jc)
    want = j_quant.quantize_params(params)
    want_dq = j_quant.dequantize_params(want)
    got = t_quant.quantize_params(lm_params_from_numpy(params),
                                  pattern_len=len(tc.pattern))
    got_dq = t_quant.dequantize_params(got)
    n_q = 0
    for path, leaf in tree_lib.leaves_with_path(got):
        w, sb = _jax_stacked_leaf(want, path, len(jc.pattern))
        wdq, _ = _jax_stacked_leaf(want_dq, path, len(jc.pattern))
        dq = tree_lib.at(got_dq, path)
        if isinstance(leaf, t_quant.QTensor):
            n_q += 1
            assert isinstance(w, j_quant.QTensor), path
            vals, scale = np.asarray(w.values), np.asarray(w.scale)
            if sb is not None:
                vals, scale = vals[sb], scale[0]
            np.testing.assert_array_equal(leaf.values.numpy(), vals)
            np.testing.assert_array_equal(leaf.scale.numpy(), scale)
            ref_dq = np.asarray(wdq)[sb] if sb is not None else \
                np.asarray(wdq)
            np.testing.assert_array_equal(dq.numpy(), ref_dq)
        else:
            assert not isinstance(w, j_quant.QTensor), path
    assert n_q > 0


def test_is_weight_leaf_reads_the_stacked_rank():
    """A per-layer norm ``w`` is rank 1 in the port's layer but rank 2 in
    JAX's stack, so it is quantized with ``pattern_len`` and not without;
    the final norm (rank 1 in both) never is."""
    cfg = t_configs.get("h2o-danube-1.8b").reduced()
    from repro_torch.models import transformer as t_tr
    params = t_tr.init_params(cfg, 0)
    stacked = t_quant.quantize_params(params, pattern_len=len(cfg.pattern))
    flat = t_quant.quantize_params(params)
    assert isinstance(stacked["layers"][0]["norm1"]["w"], t_quant.QTensor)
    assert not isinstance(flat["layers"][0]["norm1"]["w"], t_quant.QTensor)
    assert not isinstance(stacked["final_norm"]["w"], t_quant.QTensor)
    assert isinstance(flat["layers"][1]["mixer"]["wq"], t_quant.QTensor)


def _qtensors(tree):
    """(path, leaf) of a tree's QTensors (JAX's or the port's; a JAX tree
    of dicts and lists walks as the port's does)."""
    for p, leaf in tree_lib.leaves_with_path(tree):
        if hasattr(leaf, "values") and hasattr(leaf, "scale"):
            yield p, leaf


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_quantize_vit_and_swin_match_jax(family):
    name = "vit_edge" if family == "vit" else "swin_t"
    cfg = j_reg.build_cfg(name)
    params = j_reg.init_params(jax.random.PRNGKey(0), cfg)
    j_fn, t_fn = ((j_vit.quantize_vit, t_vit.quantize_vit) if family == "vit"
                  else (j_swin.quantize_swin, t_swin.quantize_swin))
    want = dict(_qtensors(j_fn(params)))
    got = dict(_qtensors(t_fn(params_from_numpy(params))))
    assert set(got) == set(want) and got
    for path, q in got.items():
        np.testing.assert_array_equal(q.values.numpy(),
                                      np.asarray(want[path].values))
        np.testing.assert_array_equal(q.scale.numpy(),
                                      np.asarray(want[path].scale))


def test_deit_s_layer_norm_and_error_bound_match_jax():
    j_cfg, t_cfg = j_vit.deit_s(), t_vit.deit_s()
    for f in dataclasses.fields(t_cfg):
        assert getattr(t_cfg, f.name) == getattr(j_cfg, f.name), f.name
    assert (t_cfg.tokens, t_cfg.head_dim, t_cfg.mlp_hidden) == \
        (196, 64, 1536)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    want = j_layers.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = t_layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    q = t_quant.quantize_per_channel(torch.from_numpy(x[0]))
    jq = j_quant.quantize_per_channel(jnp.asarray(x[0]))
    bound = t_quant.quant_error_bound(torch.from_numpy(x[0]), q.scale)
    assert bound == j_quant.quant_error_bound(jnp.asarray(x[0]), jq.scale)
    err = float((q.dequantize() - torch.from_numpy(x[0])).abs().max())
    assert err <= bound * (1 + 1e-6)
