"""The port's GPipe schedule (`repro_torch.distributed.pipeline`) on four
gloo ranks on the CPU (`launch.mesh`, one pool for the module), held
against the sequential tanh stages of the JAX package's
`test_gpipe_matches_sequential_subprocess` on the same numpy weights,
within its 1e-5; along the data axis of a 4 x 1 mesh and along the model
axis of a 2 x 2 mesh; and `bubble_fraction`."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_ranks import gpipe
from repro.distributed.pipeline import bubble_fraction as j_bubble
from repro_torch.distributed.pipeline import bubble_fraction
from repro_torch.launch import mesh as t_mesh

RANKS = 4


@pytest.fixture(scope="module")
def pool():
    world = t_mesh.start_world(RANKS, "cpu", timeout_s=120)
    yield world
    world.close()


def _weights(n_stages, n_mb=8, d=16):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32)
    bs = (rng.standard_normal((n_stages, d)) * 0.1).astype(np.float32)
    mbs = rng.standard_normal((n_mb, 4, d)).astype(np.float32)
    return ws, bs, mbs


def _sequential(ws, bs, mbs):
    """The JAX test's reference: the stages one after another."""
    ref = jnp.asarray(mbs)
    for s in range(ws.shape[0]):
        ref = jnp.tanh(ref @ ws[s] + bs[s])
    return np.asarray(ref)


@pytest.mark.parametrize("shape,axis", [((4, 1), "data"),
                                        ((2, 2), "model")])
def test_gpipe_matches_sequential(pool, shape, axis):
    mesh = t_mesh.make_vision_mesh(*shape, device="cpu")
    n_stages = shape[0] if axis == "data" else shape[1]
    ws, bs, mbs = _weights(n_stages)
    want = _sequential(ws, bs, mbs)
    outs = t_mesh.per_rank(mesh, gpipe, mesh, axis, ws, bs, mbs)
    assert len(outs) == RANKS
    for out in outs:                       # every rank holds the outputs
        assert out.shape == want.shape
        assert float(np.abs(out - want).max()) < 1e-5


def test_gpipe_single_stage_is_the_stage():
    ws, bs, mbs = _weights(1, n_mb=3)
    mesh = t_mesh.make_vision_mesh(1, 1, "cpu")
    out = gpipe(mesh, "data", ws, bs, mbs)
    assert float(np.abs(out - _sequential(ws, bs, mbs)).max()) < 1e-5


def test_bubble_fraction():
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(1, 8) == 0.0
    for d, m in ((2, 4), (4, 4), (8, 32)):
        assert bubble_fraction(d, m) == j_bubble(d, m)
