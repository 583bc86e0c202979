"""The port's optimizer (`repro_torch.optim`) held against the JAX
package's `repro.optim` on the CPU, on the same numpy inputs: the three
learning-rate schedules step by step; global-norm clipping; AdamW on a
stacked JAX tree against the port's unstacked one, where the weight-decay
rule must follow the JAX leaf's rank (a per-layer vector is rank 2 in
the stacked tree and decays; the unstacked final norm does not); int8
compression codes (round half to even), their decode, the shared scale
of a stacked leaf, and the error-feedback residuals; and the compressed
run converging as the JAX package's does.

Tolerance: float32 on both sides, the same operations; 1e-6 relative
(pow, cos and the square root may round one ulp apart), the int8 codes
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import schedules as j_sched
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compress as t_compress
from repro_torch.optim import schedules as t_sched

REL = 1e-6


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max(initial=0.0)) <= rel * max(
        1e-30, float(np.abs(want).max(initial=0.0))), (got, want)


@pytest.mark.parametrize("name,args", [
    ("constant_lr", (3e-4,)),
    ("cosine_schedule", (1e-3, 10)),
    ("cosine_schedule", (2e-3, 7, 0.0)),
    ("linear_warmup_cosine", (1e-3, 3, 12)),
    ("linear_warmup_cosine", (1e-3, 0, 5)),
    ("linear_warmup_cosine", (5e-4, 20, 100)),
])
def test_schedules_match_jax(name, args):
    j_fn, t_fn = getattr(j_sched, name)(*args), getattr(t_sched, name)(*args)
    for step in range(0, 25):
        want = j_fn(jnp.asarray(step))
        got = t_fn(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, want)
        _close(t_fn(torch.tensor(step)), want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((7, 5)).astype(np.float32),
             "b": [rng.standard_normal(11).astype(np.float32)]}
    j_out, j_norm = j_adamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    t_out, t_norm = t_adamw.clip_by_global_norm(
        tree_lib.tree_map(torch.from_numpy, grads), max_norm)
    _close(t_norm, j_norm)
    _close(t_out["a"], j_out["a"])
    _close(t_out["b"][0], j_out["b"][0])
    assert (float(t_norm) > max_norm) == (max_norm == 0.5)


def _stacked_tree(rng, sb=3, d=8, f=12):
    """A JAX-layout LM tree: one pattern position stacked over ``sb``
    superblocks (matrices and per-layer vectors), an unstacked final norm
    vector and embedding."""
    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": n(16, d),
            "layers": ({"norm1": {"w": n(sb, d)},
                        "mixer": {"wq": n(sb, d, d), "bq": n(sb, d)},
                        "mlp": {"w_up": n(sb, d, f)}},),
            "final_norm": {"w": n(d)}}


def test_decay_mask_follows_the_jax_leaf_rank():
    tree = convert.lm_params_from_numpy(_stacked_tree(
        np.random.default_rng(0)))
    mask = t_adamw.decay_mask(tree)
    for layer in mask["layers"]:
        assert layer == {"norm1": {"w": True},
                         "mixer": {"wq": True, "bq": True},
                         "mlp": {"w_up": True}}
    assert mask["final_norm"]["w"] is False and mask["embed"] is True
    assert t_adamw.decay_mask({"w": torch.zeros(4)}) == {"w": False}


def test_adamw_update_on_unstacked_tree_matches_stacked_jax():
    """Three AdamW steps at weight decay 0.1: the JAX stacked tree and the
    port's unstacked one give the same params and moments leaf for leaf
    (the per-layer vectors decayed, the final norm not)."""
    rng = np.random.default_rng(1)
    params = _stacked_tree(rng)
    cfg_j, cfg_t = j_adamw.AdamWConfig(), t_adamw.AdamWConfig()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_adamw.adamw_init(jp)
    tp = convert.lm_params_from_numpy(params)
    ts = t_adamw.adamw_init(tp)
    assert ts["count"].dtype == torch.int32
    for step, lr in enumerate((1e-2, 5e-2, 2e-2)):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            params)
        jp, js, jm = j_adamw.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, grads), js, jp,
            jnp.asarray(lr, jnp.float32), cfg_j)
        tp, ts, tm = t_adamw.adamw_update(
            convert.lm_params_from_numpy(grads), ts, tp,
            torch.tensor(lr, dtype=torch.float32), cfg_t)
        _close(tm["grad_norm"], jm["grad_norm"])
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            want = convert.lm_params_from_numpy(want)
            for path, leaf in tree_lib.leaves_with_path(got):
                assert leaf.dtype == torch.float32
                _close(leaf, tree_lib.at(want, path).numpy(), 1e-5)
        assert int(ts["count"]) == int(js["count"]) == step + 1
    # The rule by the leaf's own rank (what the blocks get outside
    # ``layers``) leaves the per-layer vectors undecayed, which this weight
    # decay shows: one step from the same state lands elsewhere.
    grads = convert.lm_params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.ones(a.shape, np.float32), params))
    def rename(t):
        return {("blocks" if k == "layers" else k): v for k, v in t.items()}
    own = t_adamw.adamw_update(rename(grads), {
        "m": rename(ts["m"]), "v": rename(ts["v"]), "count": ts["count"]},
        rename(tp), 0.1, cfg_t)[0]
    stacked = t_adamw.adamw_update(grads, ts, tp, 0.1, cfg_t)[0]
    assert not torch.allclose(own["blocks"][0]["norm1"]["w"],
                              stacked["layers"][0]["norm1"]["w"])
    assert torch.equal(own["blocks"][0]["mlp"]["w_up"],
                       stacked["layers"][0]["mlp"]["w_up"])


def test_bf16_params_keep_dtype_with_fp32_moments():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    state = t_adamw.adamw_init(p)
    g = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    new_p, new_s, _ = t_adamw.adamw_update(g, state, p, 1e-3)
    assert new_p["w"].dtype == torch.bfloat16
    assert new_s["m"]["w"].dtype == new_s["v"]["w"].dtype == torch.float32


@pytest.mark.parametrize("seed", range(4))
def test_compress_int8_codes_identical(seed):
    """Random tensors over eight decades, and one whose codes sit exactly
    on the half-way points (round half to even on both sides)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((33, 17)) * 10.0 ** rng.uniform(-8, 2)
         ).astype(np.float32)
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5],
                    np.float32)
    for a in (g, half):
        jq, js = j_compress.compress_int8(jnp.asarray(a))
        tq, tsc = t_compress.compress_int8(torch.from_numpy(a))
        assert tq.dtype == torch.int8
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert float(tsc) == float(js)
        assert np.array_equal(
            t_compress.decompress_int8(tq, tsc).numpy(),
            np.asarray(j_compress.decompress_int8(jq, js)))
    assert t_compress.compress_int8(torch.from_numpy(half))[0].tolist()[
        :7] == [127, 0, 2, 2, 0, -2, -2]


def test_ef_compress_grads_residuals_match_jax():
    """Five steps of error feedback on a stacked tree: decoded gradients
    and residuals equal, the codes' scale shared over the stack (the
    port's per-layer leaves use the JAX stack's amax)."""
    rng = np.random.default_rng(2)
    tree = _stacked_tree(rng)
    j_res = j_compress.ef_init(jax.tree_util.tree_map(jnp.asarray, tree))
    t_res = t_compress.ef_init(convert.lm_params_from_numpy(tree))
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(
                np.float32), tree)
        j_dec, j_res = j_compress.ef_compress_grads(
            jax.tree_util.tree_map(jnp.asarray, grads), j_res)
        t_dec, t_res = t_compress.ef_compress_grads(
            convert.lm_params_from_numpy(grads), t_res, pattern_len=1)
        for got, want in ((t_dec, j_dec), (t_res, j_res)):
            want = convert.lm_params_from_numpy(want)
            for path, leaf in tree_lib.leaves_with_path(got):
                assert np.array_equal(leaf.numpy(),
                                      tree_lib.at(want, path).numpy())
    assert t_compress.stack_key(("layers", 5, "mlp", "w_up"), 3) == \
        ("layers", 2, "mlp", "w_up")
    assert t_compress.stack_key(("embed",), 3) == ("embed",)


# Near the optimum Adam's steps are about the gradients' signs, so the two
# runs part by rounding there; they are held step for step until then.
STEP_FOR_STEP = 100


def test_compressed_training_converges():
    """The JAX package's `test_compressed_training_converges` on the port,
    step for step against the JAX run for its first STEP_FOR_STEP steps
    (within 1e-5), then both converged."""
    t_params = {"w": torch.tensor([4.0, -2.0])}
    t_state, t_res = t_adamw.adamw_init(t_params), \
        t_compress.ef_init(t_params)
    j_params = {"w": jnp.asarray([4.0, -2.0])}
    j_state, j_res = j_adamw.adamw_init(j_params), \
        j_compress.ef_init(j_params)
    cfg_t = t_adamw.AdamWConfig(weight_decay=0.0)
    cfg_j = j_adamw.AdamWConfig(weight_decay=0.0)
    for step in range(300):
        w = t_params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), w)
        grads, t_res = t_compress.ef_compress_grads({"w": g}, t_res)
        t_params, t_state, _ = t_adamw.adamw_update(
            grads, t_state, t_params, torch.tensor(0.05), cfg_t)
        jg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(j_params)
        jg, j_res = j_compress.ef_compress_grads(jg, j_res)
        j_params, j_state, _ = j_adamw.adamw_update(
            jg, j_state, j_params, jnp.asarray(0.05), cfg_j)
        if step < STEP_FOR_STEP:
            assert float((t_params["w"] - torch.from_numpy(np.asarray(
                j_params["w"]))).abs().max()) <= 1e-5, step
    assert float(t_params["w"].abs().max()) < 0.1
    assert float(jnp.max(jnp.abs(j_params["w"]))) < 0.1
