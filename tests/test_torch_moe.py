"""The port's MoE feed-forward (`repro_torch.models.layers.moe_forward`)
held against the JAX package's on the CPU: the same JAX weights
(`moe_init`, carried over by `convert.params_from_numpy`) and the same
numpy inputs, in float32.

Routing is discrete, so the cases cover where the two could part: the
capacity the reduced configs use (4.0, nothing dropped) and 1.25 and 1.0,
where tokens are dropped (a case checks that some are); ties in the
router (a zero router: every expert equally likely), broken toward the
lower expert id as `jax.lax.top_k` breaks them; the virtual-expert
expansion (``ep_virtual`` 2 and 4 against 1); the Switch aux loss; and
the dropless capacity of decode.

Tolerance: 2e-5 of the output scale (float32 on both sides, the same
products in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro_torch import convert
from repro_torch.models import layers as t_layers

REL = 2e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(
        1.0, float(np.abs(want).max()))


def _cfgs(**kw):
    """The JAX and the port's `MoEConfig` of the same fields."""
    return j_layers.MoEConfig(**kw), t_layers.MoEConfig(**kw)


def _setup(seed, g, s, **kw):
    jc, tc = _cfgs(**kw)
    jp = j_layers.moe_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (g, s, jc.d_model)).astype(np.float32)
    return jc, tc, jp, convert.params_from_numpy(jp), x


def _dropped(tp, x, tc) -> int:
    """The (token, choice) pairs past their expert's capacity."""
    g, s, _ = x.shape
    cap = min(max(int(tc.capacity_factor * s * tc.top_k / tc.n_experts),
                  1), s)
    _, _, idx = t_layers.moe_route(tp, torch.from_numpy(x), tc.top_k)
    counts = torch.nn.functional.one_hot(idx, tc.n_experts).sum((1, 2))
    return int(torch.clamp(counts - cap, min=0).sum())


@pytest.mark.parametrize("capacity", [4.0, 1.25, 1.0])
@pytest.mark.parametrize("gated,activation", [(True, "silu"),
                                              (False, "gelu")])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 4)])
def test_moe_forward_matches_jax(capacity, gated, activation, e, k):
    jc, tc, jp, tp, x = _setup(e + k, 3, 24, d_model=32, d_ff=16,
                               n_experts=e, top_k=k, gated=gated,
                               activation=activation,
                               capacity_factor=capacity)
    want = j_layers.moe_forward(jp, jnp.asarray(x), jc)
    got = t_layers.moe_forward(tp, torch.from_numpy(x), tc)
    _close(got.numpy(), want)
    if capacity < 2.0:
        assert _dropped(tp, x, tc) > 0          # the drop path ran
    else:
        assert _dropped(tp, x, tc) == 0


@pytest.mark.parametrize("capacity", [4.0, 1.0])
@pytest.mark.parametrize("v", [2, 4])
def test_virtual_experts_equal_their_parents_and_jax(capacity, v):
    jc, tc, jp, tp, x = _setup(7, 2, 16, d_model=32, d_ff=48, n_experts=4,
                               top_k=2, capacity_factor=capacity)
    one = t_layers.moe_forward(tp, torch.from_numpy(x), tc)
    got = t_layers.moe_forward(tp, torch.from_numpy(x),
                               dataclasses.replace(tc, ep_virtual=v))
    want = j_layers.moe_forward(jp, jnp.asarray(x),
                                dataclasses.replace(jc, ep_virtual=v))
    _close(got.numpy(), want)
    if capacity >= 2.0:     # dropless: the slices sum to their parent
        np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="ep_virtual"):
        t_layers.moe_forward(tp, torch.from_numpy(x),
                             dataclasses.replace(tc, ep_virtual=5))


@pytest.mark.parametrize("capacity", [4.0, 1.25])
def test_aux_loss_matches_jax(capacity):
    jc, tc, jp, tp, x = _setup(3, 2, 20, d_model=16, d_ff=8, n_experts=8,
                               top_k=2, capacity_factor=capacity)
    y_j, aux_j = j_layers.moe_forward(jp, jnp.asarray(x), jc,
                                      return_aux=True)
    y_t, aux_t = t_layers.moe_forward(tp, torch.from_numpy(x), tc,
                                      return_aux=True)
    _close(y_t.numpy(), y_j)
    assert aux_t.dtype == torch.float32 and aux_t.dim() == 0
    assert abs(float(aux_t) - float(aux_j)) <= 1e-6 * max(1.0,
                                                         float(aux_j))


def test_uniform_router_aux_is_one_and_ties_go_to_the_lower_id():
    """A zero router makes every expert equally likely: the aux loss is 1
    (the JAX package's test of it), and the top k are the k lowest ids,
    as `jax.lax.top_k` chooses, so the outputs equal JAX's."""
    jc, tc, jp, tp, x = _setup(0, 2, 32, d_model=16, d_ff=8, n_experts=4,
                               top_k=2, capacity_factor=1.0)
    jp = dict(jp, router=jnp.zeros((16, 4)))
    tp = dict(tp, router=torch.zeros((16, 4)))
    _, aux = t_layers.moe_forward(tp, torch.from_numpy(x), tc,
                                  return_aux=True)
    assert abs(float(aux) - 1.0) < 1e-5
    _, vals, idx = t_layers.moe_route(tp, torch.from_numpy(x), 2)
    assert (idx == torch.tensor([0, 1])).all() and (vals == 0.5).all()
    _close(t_layers.moe_forward(tp, torch.from_numpy(x), tc).numpy(),
           j_layers.moe_forward(jp, jnp.asarray(x), jc))


def test_route_matches_jax_top_k():
    jc, tc, jp, tp, x = _setup(5, 3, 17, d_model=24, d_ff=8, n_experts=16,
                               top_k=4)
    probs_j = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    vals_j, idx_j = jax.lax.top_k(probs_j, 4)
    probs, vals, idx = t_layers.moe_route(tp, torch.from_numpy(x), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(probs.numpy(), probs_j)
    _close(vals.numpy(), vals_j / vals_j.sum(-1, keepdims=True))


def test_dropless_decode_never_drops():
    """The JAX package's decode-capacity test on the port: every token of
    a group routed to the same experts, at capacity n_experts / top_k,
    keeps its output; and each decode row (a group of one) equals JAX's."""
    jc, tc, jp, tp, _ = _setup(0, 1, 8, d_model=16, d_ff=8, n_experts=4,
                               top_k=2, capacity_factor=4 / 2)
    row = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    x = np.broadcast_to(row, (1, 8, 16)).copy()
    y = t_layers.moe_forward(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(y[0, 0].numpy(), y[0, -1].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float(y.abs().max()) > 0
    _close(y.numpy(), j_layers.moe_forward(jp, jnp.asarray(x), jc))
    rows = np.random.default_rng(2).standard_normal((5, 1, 16)).astype(
        np.float32)
    _close(t_layers.moe_forward(tp, torch.from_numpy(rows), tc).numpy(),
           j_layers.moe_forward(jp, jnp.asarray(rows), jc))


def test_moe_init_shapes_and_dtypes():
    _, tc = _cfgs(d_model=16, d_ff=8, n_experts=4, top_k=2)
    p = t_layers.moe_init(torch.Generator().manual_seed(0), tc,
                          torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert (p["router"].shape, p["w_up"].shape, p["w_gate"].shape,
            p["w_down"].shape) == ((16, 4), (4, 16, 8), (4, 16, 8),
                                   (4, 8, 16))
    assert p["w_up"].dtype == torch.bfloat16
    ungated = t_layers.moe_init(torch.Generator().manual_seed(0),
                                dataclasses.replace(tc, gated=False),
                                torch.float32)
    assert "w_gate" not in ungated
    assert torch.equal(t_layers.cast_f32_mp(p["w_up"]), p["w_up"].float())
