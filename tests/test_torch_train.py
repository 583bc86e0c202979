"""The port's train step (`repro_torch.launch.steps.make_train_step`) held
against the JAX package's on the CPU, at `reduced()` of all ten configs
in float32: the same JAX weights and optimizer state carried over by
`convert.lm_params_from_numpy` / `convert.lm_opt_state_from_numpy`, the
same `SyntheticLM` batches, through the loss, its metrics, every
gradient leaf (`steps.loss_and_grads` against `jax.value_and_grad` of
`transformer.loss_fn`), every updated parameter and the AdamW moments
``m`` and ``v`` (weight decay on the per-layer vectors as the JAX
package's stacked tree applies it).  h2o-danube-1.8b runs three steps,
with int8 gradient compression off and on (the error-feedback residuals
compared too) and with ``remat``; ``bf16_reduce`` (the ``rms_mp`` norm
and the cotangent clamps) is held against the JAX package's custom VJPs,
in float32 through the step and in bf16 leaf by leaf, where the
cotangent comes back in x's dtype.

Tolerance: float32 on both sides, the same arithmetic in another order,
so 2e-5 of each leaf's scale (its largest magnitude; measured: at most
about 2e-6 on the gradients, 1.7e-5 for RecurrentGemma-2B's), v at twice
that (it squares the gradient); xLSTM at 5e-4, as its forward
(`tests/test_torch_lm.py`: its mLSTM blocks amplify float32 rounding one
after another).  The updated parameters: AdamW's step divides m by
sqrt(v), which is ill-conditioned where a gradient lies within its
tolerance of 0 (at the first step it is about the gradient's sign), so
the port's step tail (`steps.apply_grads`: compression and AdamW) on
JAX's own gradients and state is held at the leaf bound, every element;
the port's own step (its own gradients) element by element at the leaf
bound plus twice the spread between four shadow runs of that tail on
JAX's gradients moved by their tolerance at every step (all up, all
down, two random sign patterns): the error the gradients' tolerance
alone can give (an int8 code that flips at a rounding boundary, a step
near zero that changes sign); the residuals also carry the gradients'
own error (twice their tolerance a step).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import steps as j_steps
from repro.models import layers as j_layers
from repro.models import transformer as j_tr
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro.optim import linear_warmup_cosine as j_lwc
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps as t_steps
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tr
from repro_torch.optim import linear_warmup_cosine as t_lwc

ARCHS = t_configs.list_archs()
REL = 2e-5
REL_XLSTM = 5e-4
SEQ, BATCH = 12, 2


def _rel(arch):
    return REL_XLSTM if arch == "xlstm-1.3b" else REL


def _close_leaf(name, got, want, rel):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want.float().numpy() if torch.is_tensor(want)
                      else want, np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-30, (name, err, scale)


def _close_tree(what, got, want_jax, rel):
    """Every leaf of the port tree ``got`` against the JAX tree
    ``want_jax`` (stacked), unstacked by `convert`."""
    _close_port_tree(what, got, convert.lm_params_from_numpy(want_jax), rel)


def _close_port_tree(what, got, want, rel):
    for path, leaf in tree_lib.leaves_with_path(got):
        _close_leaf(f"{what} {tree_lib.path_key(path)}", leaf,
                    tree_lib.at(want, path), rel)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _setup(arch, **overrides):
    jc = dataclasses.replace(j_configs.get(arch).reduced(), **overrides)
    tc = dataclasses.replace(t_configs.get(arch).reduced(), **overrides)
    jp = j_tr.init_params(jax.random.PRNGKey(0), jc)
    data = JSyntheticLM(jc.vocab, SEQ, BATCH, seed=1,
                        n_image_tokens=jc.n_image_tokens,
                        d_model=jc.d_model, input_mode=jc.input_mode)
    return jc, tc, jp, data


def _run(arch, steps, compress=False, **overrides):
    """Both train steps over ``steps`` steps from the same weights and
    state; each step's JAX gradients, metrics and state held against the
    port's (module docstring)."""
    jc, tc, jp, data = _setup(arch, **overrides)
    rel = _rel(arch)
    j_state = j_steps.init_opt_state(jp, compress)
    t_params = convert.lm_params_from_numpy(jp)
    t_state = convert.lm_opt_state_from_numpy(j_state)
    j_step = j_steps.make_train_step(
        jc, lr_fn=j_lwc(1e-3, 0, steps), grad_compression=compress)

    @jax.jit
    def j_fn(p, state, b, step):
        """The JAX train step and, beside it, its loss and gradients (one
        program, one compile)."""
        (loss, _), grads = jax.value_and_grad(
            lambda q: j_tr.loss_fn(q, b, jc), has_aux=True)(p)
        return (loss, grads), j_step(p, state, b, step)

    j_tail = jax.jit(functools.partial(_j_tail, compress))
    t_lr = t_lwc(1e-3, 0, steps)
    t_fn = t_steps.make_train_step(tc, lr_fn=t_lr, grad_compression=compress)
    tiny = SyntheticLM(tc.vocab, SEQ, BATCH, seed=1,
                       n_image_tokens=tc.n_image_tokens,
                       d_model=tc.d_model, input_mode=tc.input_mode)
    shadows = {key: (t_params, t_state) for key in SHADOWS}
    g_tol = tree_lib.tree_map(lambda _: 0.0, t_params)
    for step in range(steps):
        batch = data.batch_at(step)
        j_prev = (jp, j_state, convert.lm_params_from_numpy(jp),
                  convert.lm_opt_state_from_numpy(j_state))
        (j_loss, j_g), (jp, j_state, j_m) = j_fn(jp, j_state, _jb(batch),
                                                 jnp.asarray(step))
        # The gradients at the same (JAX's) params.
        t_loss, _, t_g = t_steps.loss_and_grads(j_prev[2], _tb(batch), tc)
        _close_leaf("loss", t_loss, j_loss, rel)
        _close_tree(f"step {step} grad", t_g, j_g, rel)
        t_batch = tiny.batch_at(step)
        assert all(np.array_equal(t_batch[k], batch[k]) for k in batch)
        t_params, t_state, t_m = t_fn(t_params, t_state, _tb(t_batch), step)
        assert sorted(t_m) == sorted(j_m)
        for k in j_m:
            _close_leaf(f"step {step} {k}", t_m[k], j_m[k], rel)
        assert int(t_state["adam"]["count"]) == int(j_state["adam"]["count"])

        # The port's step tail on the same gradients and state as the JAX
        # package's: every element at the leaf bound (the int8 codes
        # equal).
        g = convert.lm_params_from_numpy(j_g)
        lr = t_lr(step)
        new_p, new_s, _ = t_steps.apply_grads(
            g, *j_prev[2:], lr, grad_compression=compress,
            pattern_len=len(tc.pattern))
        tail = _state_trees(*(convert.lm_params_from_numpy(t) if i == 0
                              else convert.lm_opt_state_from_numpy(t)
                              for i, t in enumerate(j_tail(
                                  j_g, *j_prev[:2], j_lwc(1e-3, 0, steps)(
                                      jnp.asarray(step))))))
        for name, got in _state_trees(new_p, new_s).items():
            _close_port_tree(f"step {step} {name} on JAX's grads", got,
                             tail[name], rel)
        want = _state_trees(convert.lm_params_from_numpy(jp),
                            convert.lm_opt_state_from_numpy(j_state))
        # The port's own step: the leaf bound plus twice the spread the
        # gradient tolerance gives (module docstring); the residuals carry
        # the gradients' own error on top.
        for key in shadows:
            shadows[key] = t_steps.apply_grads(
                _moved(g, key, rel), *shadows[key], lr,
                grad_compression=compress, pattern_len=len(tc.pattern))[:2]
        runs = [_state_trees(*shadows[key]) for key in shadows]
        g_tol = tree_lib.tree_map(
            lambda a, t: t + 2 * rel * float(a.abs().max()), g, g_tol)
        for name, got in _state_trees(t_params, t_state).items():
            _close_spread(f"step {step} {name}", got, want[name],
                          [r[name] for r in runs], rel,
                          g_tol if name == "ef" else None)
    return t_m


def _j_tail(compress, grads, params, state, lr):
    """The JAX train step after its gradients, from the JAX package's own
    functions: (new params, new state)."""
    new_state = {}
    if compress:
        grads, new_state["ef_residuals"] = j_compress.ef_compress_grads(
            grads, state["ef_residuals"])
    new_params, new_state["adam"], _ = j_adamw.adamw_update(
        grads, state["adam"], params, lr)
    return new_params, new_state


def _state_trees(params, state):
    out = {"param": params, "m": state["adam"]["m"], "v": state["adam"]["v"]}
    if "ef_residuals" in state:
        out["ef"] = state["ef_residuals"]
    return out


# The shadow runs' gradient moves: all up, all down, and two patterns of
# random signs (seeded), each element by its leaf's tolerance.
SHADOWS = ("up", "down", 0, 1)


def _moved(grads, key, rel):
    def move(path, a):
        tau = rel * float(a.abs().max())
        if key in ("up", "down"):
            return a + (tau if key == "up" else -tau)
        gen = torch.Generator().manual_seed(
            key * 1000 + len(tree_lib.path_key(path)))
        sign = torch.randint(0, 2, a.shape, generator=gen) * 2 - 1
        return a + tau * sign
    return tree_lib.map_with_path(move, grads)


def _close_spread(what, got, want, runs, rel, extra=None):
    """Each element within ``rel`` of the leaf's scale (plus ``extra``'s
    leaf, an absolute bound) plus twice the spread of the shadow
    ``runs`` there."""
    for path, leaf in tree_lib.leaves_with_path(got):
        w = tree_lib.at(want, path).float()
        shadow = torch.stack([tree_lib.at(r, path).float() for r in runs])
        spread = shadow.max(0).values - shadow.min(0).values
        bound = rel * float(w.abs().max()) + 2 * spread
        if extra is not None:
            bound = bound + tree_lib.at(extra, path)
        err = (leaf.float() - w).abs()
        assert bool((err <= bound).all()), (
            f"{what} {tree_lib.path_key(path)}",
            float((err - bound).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One step: loss, metrics (``moe_aux`` on the MoE configs), every
    gradient, every updated parameter and both moments."""
    metrics = _run(arch, 1)
    assert ("moe_aux" in metrics) == (t_configs.get(arch).moe is not None)


@pytest.mark.parametrize("compress", [False, True])
def test_danube_three_steps_match_jax(compress):
    _run("h2o-danube-1.8b", 3, compress)


def test_danube_remat_matches_jax():
    """``remat``: the port recomputes each superblock in the backward
    (`torch.utils.checkpoint`), the JAX package `jax.checkpoint`s it."""
    _run("h2o-danube-1.8b", 2, remat=True)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_bf16_reduce_matches_jax_rms_mp(arch):
    """``bf16_reduce`` selects the ``rms_mp`` norm and clamps the block
    outputs' cotangents (with MoE, the router's f32 cast too), against the
    JAX package's custom VJPs; in float32 the same numbers as without."""
    assert t_tr._norm_kind(_setup(arch, bf16_reduce=True)[1]) == "rms_mp"
    _run(arch, 2, bf16_reduce=True)


def test_rms_mp_vjps_in_bf16_return_x_dtype():
    """In bf16 the rms_mp backward, `cast_f32_mp` and `clamp_cotangent`
    give the cotangent in x's dtype, equal to the JAX package's (dx, and
    the f32 cotangents of the cast and the clamp, rounded once)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jx, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, g))

    y, vjp = jax.vjp(j_layers.rms_norm_mp, jx, jw)
    j_dx, j_dw = vjp(jg)
    tx, tw = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for a in (jx, jw))
    tg = torch.from_numpy(np.asarray(jg.astype(jnp.float32))).to(
        torch.bfloat16)
    t_y = t_layers.rms_norm_mp(tx, tw)
    t_dx, t_dw = torch.autograd.grad(t_y, (tx, tw), tg)
    assert t_y.dtype == t_dx.dtype == t_dw.dtype == torch.bfloat16
    assert np.array_equal(t_y.detach().float().numpy(),
                          np.asarray(y.astype(jnp.float32)))
    _close_leaf("dx", t_dx, np.asarray(j_dx.astype(jnp.float32)), 1e-2)
    _close_leaf("dw", t_dw, np.asarray(j_dw.astype(jnp.float32)), 1e-2)

    g32 = jnp.asarray(g)
    for j_fn, t_fn, to_f32 in ((j_layers.cast_f32_mp, t_layers.cast_f32_mp,
                                True),
                               (j_layers.clamp_cotangent,
                                t_layers.clamp_cotangent, False)):
        _, vjp = jax.vjp(j_fn, jx)
        (j_ct,) = vjp(g32 if to_f32 else jg)
        tx = tx.detach().requires_grad_()
        out = t_fn(tx)
        assert out.dtype == (torch.float32 if to_f32 else torch.bfloat16)
        (t_ct,) = torch.autograd.grad(
            out, tx, torch.from_numpy(g) if to_f32 else tg)
        assert t_ct.dtype == torch.bfloat16
        assert np.array_equal(t_ct.float().numpy(),
                              np.asarray(j_ct.astype(jnp.float32)))


def test_apply_norm_rms_mp_forward_is_rms():
    x = torch.randn(3, 16)
    w = torch.randn(16) * 0.1
    assert torch.equal(t_layers.apply_norm(x, {"w": w}, "rms_mp"),
                       t_layers.apply_norm(x, {"w": w}, "rms"))
    with pytest.raises(ValueError, match="norm"):
        t_layers.apply_norm(x, {"w": w}, "bogus")


@pytest.mark.parametrize("arch", ["internvl2-26b", "h2o-danube-1.8b"])
def test_loss_drops_image_positions_and_padding_columns(arch, monkeypatch):
    """The loss reads the real vocabulary of the text positions only: a
    change to the padding columns' or the image positions' logits leaves
    it unchanged, as in the JAX package's `loss_fn`."""
    jc, tc, jp, data = _setup(arch)
    params = convert.lm_params_from_numpy(jp)
    batch = _tb(data.batch_at(0))
    base, _ = t_tr.loss_fn(params, batch, tc)
    real = t_tr.forward

    def forward(p, b, cfg, return_aux=False):
        logits = real(p, b, cfg, return_aux)
        if return_aux:
            logits = logits[0]
        logits = logits.clone()
        logits[..., cfg.vocab:] = 1e4
        logits[:, :cfg.n_image_tokens] = -1e4
        return logits

    monkeypatch.setattr(t_tr, "forward", forward)
    moved, _ = t_tr.loss_fn(params, batch, tc)
    assert float(moved) == float(base)
    j_loss, _ = j_tr.loss_fn(jp, _jb(data.batch_at(0)), jc)
    _close_leaf("loss", base, np.asarray(j_loss), REL)


def test_active_params_and_model_flops_match_jax():
    for arch in ("h2o-danube-1.8b", "olmoe-1b-7b"):
        jc, tc, jp, _ = _setup(arch)
        tp = convert.lm_params_from_numpy(jp)
        assert t_steps.active_param_count(tc, tp) == \
            j_steps.active_param_count(jc, jp)
        assert t_steps.model_flops(tc, tp, "train", 512) == \
            j_steps.model_flops(jc, jp, "train", 512)
