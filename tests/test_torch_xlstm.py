"""The port's xLSTM mixers (`repro_torch.models.xlstm`) held against the
JAX package's on the CPU, at `reduced()` xlstm-1.3b (d_model 64, 4
heads: mLSTM d_inner 128, head dim 32; sLSTM head dim 16): the same JAX
weights (carried over by `convert.params_from_numpy`) and numpy inputs
through each function, the prefill states and decode steps included; and
the port's own parallel mLSTM against its recurrent form (the JAX
package's property test, on the port).

Tolerance: 2e-5 of the output scale (float32 on both sides); the
parallel-recurrent property at the JAX test's 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as j_configs
from repro.models import xlstm as j_x
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.models import xlstm as t_x

from _hypothesis_compat import given, settings, strategies as st

REL = 2e-5
JC = j_configs.get("xlstm-1.3b").reduced()
TC = t_configs.get("xlstm-1.3b").reduced()


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(
        1.0, float(np.abs(want).max()))


def _params(kind, seed=1):
    jp = getattr(j_x, f"{kind}_init")(jax.random.PRNGKey(seed), JC,
                                      jnp.float32)
    return jp, convert.params_from_numpy(jp)


def _x(b, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, t, JC.d_model)).astype(np.float32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("t", [1, 11])
def test_forward_matches_jax(kind, t):
    jp, tp = _params(kind)
    x = _x(2, t)
    want = getattr(j_x, f"{kind}_forward")(jp, jnp.asarray(x), JC)
    got = getattr(t_x, f"{kind}_forward")(tp, torch.from_numpy(x), TC)
    _close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_states_and_decode_steps_match_jax(kind):
    """Prefill of 9 tokens (output and every state tensor), then 3
    decode steps, each output and state against JAX's."""
    jp, tp = _params(kind, seed=2)
    x = _x(3, 9, seed=1)
    j_out, j_cache = getattr(j_x, f"{kind}_prefill")(jp, jnp.asarray(x),
                                                      JC, 16)
    t_out, t_cache = getattr(t_x, f"{kind}_prefill")(tp, torch.from_numpy(x),
                                                      TC, 16)
    _close(t_out.numpy(), j_out)
    assert t_cache.keys() == j_cache.keys()
    for key in t_cache:
        assert t_cache[key].dtype == torch.float32
        _close(t_cache[key].numpy(), j_cache[key])
    rows = _x(3, 3, seed=2)
    for i in range(3):
        j_out, j_cache = getattr(j_x, f"{kind}_decode")(
            jp, jnp.asarray(rows[:, i]), j_cache, None, JC)
        t_out, t_cache = getattr(t_x, f"{kind}_decode")(
            tp, torch.from_numpy(rows[:, i]), t_cache, None, TC)
        _close(t_out.numpy(), j_out)
        for key in t_cache:
            _close(t_cache[key].numpy(), j_cache[key])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_caches_match_jax(kind):
    want = getattr(j_x, f"{kind}_init_cache")(JC, 2, 8, jnp.float32)
    got = getattr(t_x, f"{kind}_init_cache")(TC, 2, 8, torch.float32)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_shapes_and_dtypes_match_jax(kind):
    """The port's own random init draws other numbers but builds the
    JAX tree: the same keys, shapes and dtypes (bf16 weights, float32
    gates and recurrence), and the same deterministic biases."""
    jc = j_configs.get("xlstm-1.3b").reduced(dtype="bfloat16")
    tc = t_configs.get("xlstm-1.3b").reduced(dtype="bfloat16")
    want = getattr(j_x, f"{kind}_init")(jax.random.PRNGKey(0), jc,
                                        jnp.bfloat16)
    got = getattr(t_x, f"{kind}_init")(torch.Generator().manual_seed(0), tc,
                                       torch.bfloat16)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    bias = "b_if" if kind == "mlstm" else "b_in"
    np.testing.assert_array_equal(got[bias].numpy(), np.asarray(want[bias]))


def test_qkvif_and_headnorm_match_jax():
    jp, tp = _params("mlstm", seed=3)
    u = np.random.default_rng(3).standard_normal((2, 5, 2 * JC.d_model)
                                                 ).astype(np.float32)
    want = j_x._mlstm_qkvif(jp, jnp.asarray(u), JC.n_heads)
    got = t_x._mlstm_qkvif(tp, torch.from_numpy(u), TC.n_heads)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    y = np.random.default_rng(4).standard_normal((2, 5, 4, 32)).astype(
        np.float32)
    w = np.random.default_rng(5).standard_normal(128).astype(np.float32)
    _close(t_x._headnorm(torch.from_numpy(y), torch.from_numpy(w)).numpy(),
           j_x._headnorm(jnp.asarray(y), jnp.asarray(w)))


def _gates(seed, b, h, t, dh):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, t, dh), generator=g) for _ in range(3))
    log_i = torch.randn((b, h, t), generator=g)
    log_f = F.logsigmoid(torch.randn((b, h, t), generator=g) + 2.0)
    return q, k, v, log_i, log_f


@given(st.integers(0, 10 ** 6))
@settings(max_examples=8, deadline=None)
def test_mlstm_parallel_equals_recurrent(seed):
    """Property: the stabilised parallel mLSTM equals the step-by-step
    recurrence (the JAX package's test of its own, on the port)."""
    b, h, t, dh = 2, 2, 9, 4
    q, k, v, log_i, log_f = _gates(seed, b, h, t, dh)
    par, _ = t_x._mlstm_parallel(q, k, v, log_i, log_f)
    state = (torch.zeros((b, h, dh, dh)), torch.zeros((b, h, dh)),
             torch.full((b, h), -1e30))
    outs = []
    for i in range(t):
        state, o = t_x._mlstm_recurrent_step(
            state, q[:, :, i], k[:, :, i], v[:, :, i], log_i[:, :, i],
            log_f[:, :, i])
        outs.append(o)
    np.testing.assert_allclose(par.numpy(), torch.stack(outs, 2).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_parallel_and_recurrent_match_jax_on_the_same_gates():
    q, k, v, log_i, log_f = _gates(11, 2, 3, 7, 8)
    j_args = [jnp.asarray(a.numpy()) for a in (q, k, v, log_i, log_f)]
    par, m = t_x._mlstm_parallel(q, k, v, log_i, log_f)
    j_par, j_m = j_x._mlstm_parallel(*j_args)
    _close(par.numpy(), j_par)
    _close(m.numpy(), j_m)
    state = (torch.zeros((2, 3, 8, 8)), torch.zeros((2, 3, 8)),
             torch.full((2, 3), -1e30))
    j_state = tuple(jnp.asarray(s.numpy()) for s in state)
    for i in range(7):
        state, o = t_x._mlstm_recurrent_step(
            state, q[:, :, i], k[:, :, i], v[:, :, i], log_i[:, :, i],
            log_f[:, :, i])
        j_state, j_o = j_x._mlstm_recurrent_step(
            j_state, *(a[:, :, i] for a in j_args))
        _close(o.numpy(), j_o)
    for s, j_s in zip(state, j_state):
        _close(s.numpy(), j_s)


def test_first_step_is_finite_with_the_minus_1e30_start():
    """m starts at -1e30: the first step's log_f + m - m_new is finite
    (at -inf it would be NaN), and the state is the first token's."""
    q, k, v, log_i, log_f = _gates(4, 1, 2, 1, 4)
    state = tuple(t_x.mlstm_init_cache(TC, 1, 1, torch.float32).values())
    state = (state[0][:, :2, :4, :4], state[1][:, :2, :4], state[2][:, :2])
    (c, n, m), h = t_x._mlstm_recurrent_step(
        state, q[:, :, 0], k[:, :, 0], v[:, :, 0], log_i[:, :, 0],
        log_f[:, :, 0])
    assert torch.isfinite(h).all() and torch.isfinite(c).all()
    torch.testing.assert_close(m, log_i[:, :, 0])
    torch.testing.assert_close(n, k[:, :, 0])
