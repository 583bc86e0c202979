"""The MSA tile's launch plan (`kernels/vita_msa.py::msa_plan`) on the CPU:
every shape the registry serves gets a cluster of at most 8 blocks whose
row slices cover N exactly, within one H100 block's shared memory
(232,448 bytes), in each dtype mode; shapes past the tile raise."""

import pytest

from repro_torch.kernels.vita_msa import SMEM_LIMIT, msa_plan
from repro_torch.models import vision_registry

# (z bytes, weight bytes) of the three dtype modes: fp32, mixed, bf16.
_SIZES = ((4, 4), (4, 2), (2, 2))


def _served_shapes():
    """(model, N, Dh) of every MSA call the registry's models make, at
    full and reduced size: a ViT's tokens, a Swin stage's window."""
    out = set()
    for name in vision_registry.list_models():
        for full in (True, False):
            cfg = vision_registry.build_cfg(name, full=full)
            if hasattr(cfg, "depths"):
                for s in range(len(cfg.depths)):
                    out.add((name, cfg.window ** 2,
                             cfg.stage_dim(s) // cfg.heads[s]))
            else:
                out.add((name, cfg.tokens, cfg.head_dim))
    return sorted(out)


def test_served_shapes_cover_the_registry():
    models = {m for m, _, _ in _served_shapes()}
    assert {"deit_t", "deit_t_p", "swin_t", "swin_t_p", "vit_edge",
            "vit_edge_p"} <= models
    assert ("deit_t", 196, 64) in _served_shapes()
    assert ("vit_edge", 256, 64) in _served_shapes()      # ViT-B/16 widths
    assert ("swin_t", 49, 32) in _served_shapes()


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("model,n,dh", _served_shapes())
def test_every_served_shape_has_a_plan(model, n, dh, z_size, w_size):
    plan = msa_plan(n, dh, z_size, w_size)
    assert plan.smem <= SMEM_LIMIT
    assert 1 <= plan.cluster <= 8 and plan.rows == 64
    assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
    assert plan.dp >= dh and plan.dp % 32 == 0


@pytest.mark.parametrize("z_size,w_size", _SIZES)
def test_slices_cover_n_exactly_up_to_the_widest(z_size, w_size):
    """From 1 token to the widest N the plan admits, the 64-row slices
    tile N with one ragged last slice, one block each."""
    widest = 0
    for n in range(1, 513):
        try:
            plan = msa_plan(n, 32, z_size, w_size)
        except ValueError:
            continue
        widest = n
        assert plan.cluster <= 8
        assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
        assert plan.cluster == -(-n // 64)
    assert widest > 256


def test_unplannable_shapes_raise():
    with pytest.raises(ValueError):
        msa_plan(196, 80)                 # Dh past the tile's 64
    with pytest.raises(ValueError):
        msa_plan(513, 32)                 # more than 8 slices of 64
    with pytest.raises(ValueError):
        msa_plan(300, 64, 4, 4)           # K and V past 227 KB


@pytest.mark.parametrize("z_size,w_size", _SIZES)
@pytest.mark.parametrize("n,dh", [(17, 24), (49, 32), (65, 64), (196, 64),
                                  (256, 64), (480, 32)])
def test_plan_buffers_lie_apart_within_the_block(n, dh, z_size, w_size):
    """The layout the launch takes as is: Q, K, V (z's type), the scores
    and, in the bf16 mode, bf16 P lie in that order without overlap; the
    projection's ring starts after Q, holds a z tile and a weight tile a
    stage and ends within the block's shared memory."""
    p = msa_plan(n, dh, z_size, w_size)
    rows, ldv = p.cluster * p.rows, p.dp + (4 if z_size == 4 else 8)
    assert p.nk >= n and p.nk % 16 == 0 and p.lds >= p.nk
    assert p.q_off + p.rows * (p.dp + 8) * 4 <= p.k_off
    assert p.k_off + rows * (p.dp + 8) * 4 <= p.v_off
    assert p.v_off + rows * ldv * z_size <= p.s_off
    assert p.s_off + 32 * p.lds * 4 <= p.p_off
    assert p.p_off + (32 * (p.nk + 8) * 2 if z_size == 2 else 0) <= p.smem
    kc = 32 if z_size == 4 else 64
    ldw = 3 * p.dp + (4 if w_size == 4 else 8)
    assert p.stage >= p.rows * (kc + 8) * z_size + kc * ldw * w_size
    assert p.ring_off >= p.k_off and 3 <= p.stages <= 8
    assert p.ring_off + p.stages * p.stage <= p.smem <= SMEM_LIMIT
