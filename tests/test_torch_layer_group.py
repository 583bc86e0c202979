"""Layer groups in the port: the grouping pass against the JAX package's,
its properties, the plain group kernels against the JAX Pallas kernels
(interpret mode) on the same numpy inputs, grouped against per-layer
execution, and the group size through the fusion policy, the server and
the CLI on the CPU.

Tolerances: the plain float group differs from the Pallas kernel by fp32
reassociation only (rtol/atol 1e-5); the int8 group may flip a requant
code by one LSB at a rounding boundary, which moves an output by about
one activation scale times a weight (2% of the output scale, and 99% of
the outputs of one layer within 1e-4), as in tests/test_torch_kernels.py;
over three layers a flip spreads to its window or image through the next
layers' attention, so 90% of the group's outputs stay within 1e-4.
Grouped and per-layer execution in the port run the same per-layer
arithmetic: int8 exactly equal, float within 1e-6 of the logit scale."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.vita_layer import vita_layer_group as j_group
from repro.kernels.vita_layer import vita_layer_group_int8 as j_group_int8
from repro.models import vision_registry as j_reg
from repro_torch.core import schedule as t_sched
from repro_torch.core.quant import Calibrator
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

MODELS = t_reg.list_models()
_FIELDS = ("kind", "path", "site", "grid", "heads", "window", "shift")


def _rows(sched):
    return [tuple(getattr(p, f) for f in _FIELDS)
            + (tuple(m.site for m in p.members),) for p in sched.phases]


# ---------------------------------------------------------------------------
# The grouping pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", range(1, 9))
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_grouped_schedule_matches_jax(name, full, group):
    t_cfg = t_reg.build_cfg(name, full=full, fuse_group=group)
    j_cfg = j_reg.build_cfg(name, full=full, fuse_group=group)
    assert t_cfg.head_mask == j_cfg.head_mask
    got = t_reg.make_schedule(t_cfg)
    assert _rows(got) == _rows(j_reg.make_schedule(j_cfg))
    assert t_sched.fuse_schedule(got, group_size=group) == got  # idempotent


def _layer_sites(sched):
    out = []
    for p in sched.phases:
        if p.kind == "layer":
            out.append(p.site)
        elif p.kind == "layer_group":
            out.extend(m.site for m in p.members)
    return out


def _vit_sched(layers, heads, mask=None):
    cfg = t_vit.ViTConfig(name="prop", image=16, patch=8, dim=8 * heads,
                          heads=heads, layers=layers, n_classes=4,
                          fused=False, head_mask=mask)
    return t_vit.schedule(cfg)


@pytest.mark.parametrize("layers,heads", [(1, 1), (3, 2), (5, 4), (8, 3)])
@pytest.mark.parametrize("group", [1, 2, 3, 5, 10])
def test_grouping_properties(layers, heads, group):
    """Exact cover in layer order, group sizes within [2, group], members
    pairwise groupable, size 1 degenerates to the fused schedule."""
    s = _vit_sched(layers, heads)
    fused = t_sched.fuse_schedule(s)
    g = t_sched.fuse_schedule(s, group_size=group)
    assert _layer_sites(g) == _layer_sites(fused)
    for p in g.phases:
        if p.kind == "layer_group":
            assert 2 <= len(p.members) <= group
            assert all(t_sched._groupable(p.members[0], q)
                       for q in p.members[1:])
            assert p.site == f"{p.members[0].site}..{p.members[-1].site}"
        else:
            assert p.members == ()
    if group == 1:
        assert g == fused


def test_partial_chunk_stays_a_plain_layer():
    c = t_reg.make_schedule(t_reg.build_cfg("vit_edge", fuse_group=3)
                            ).counts()
    assert c == {"embed": 1, "layer_group": 1, "layer": 1, "head": 1}


def test_groups_split_at_shift_stage_and_head_count():
    g = t_reg.make_schedule(t_reg.build_cfg("swin_t", full=True,
                                            fuse_group=8))
    for p in g.phases:
        if p.kind == "layer_group":
            assert len({(m.shift, m.window, m.path[:-1], m.heads)
                        for m in p.members}) == 1
    # deit_t_p's reduced mask keeps 2, 2, 1, 3 heads: one group of two
    mask = ((1, 1, 0), (0, 1, 1), (0, 1, 0), (1, 1, 1))
    g = t_sched.fuse_schedule(_vit_sched(4, 3, mask), group_size=4)
    assert [(p.kind, p.heads) for p in g.phases[1:-1]] == [
        ("layer_group", 2), ("layer", 1), ("layer", 3)]


# ---------------------------------------------------------------------------
# The plain group kernels against the JAX Pallas kernels
# ---------------------------------------------------------------------------

L, B, N, D, M = 3, 2, 16, 32, 64
_ORDER = ("wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
          "w_up", "b_up", "w_down", "b_down")


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _group_case(mode, seed=0):
    """Stacked float operands, x, bias and mask for one mode: global
    (H 2, Dh 16), windowed (four 4x4 windows of an 8x8 grid, shifted
    mask; x is the window fold of two images) or pruned (H 2, Dh 8, so
    H*Dh = 16 < D)."""
    rng = np.random.default_rng(seed)
    h, dh = (2, 8) if mode == "pruned" else (2, 16)
    p = dict(
        wq=_f32(rng, L, h, D, dh, scale=D ** -0.5),
        wk=_f32(rng, L, h, D, dh, scale=D ** -0.5),
        wv=_f32(rng, L, h, D, dh, scale=D ** -0.5),
        w_msa=_f32(rng, L, h * dh, D, scale=(h * dh) ** -0.5),
        ln1_w=1 + _f32(rng, L, D, scale=0.1), ln1_b=_f32(rng, L, D, scale=0.1),
        ln2_w=1 + _f32(rng, L, D, scale=0.1), ln2_b=_f32(rng, L, D, scale=0.1),
        w_up=_f32(rng, L, D, M, scale=D ** -0.5),
        b_up=_f32(rng, L, M, scale=0.1),
        w_down=_f32(rng, L, M, D, scale=M ** -0.5),
        b_down=_f32(rng, L, D, scale=0.1))
    bias = mask = None
    b = B
    if mode == "windowed":
        b = B * 4
        bias = _f32(rng, L, h, N, N, scale=0.5)
        mask = t_sched.shifted_window_mask(8, 8, 4, 2)
    return _f32(rng, b, N, D), p, bias, mask


def _quantized(p):
    """int8 group operands: per-(layer, head, channel) QKV and
    per-(layer, channel) matmul weights, and fixed (L, 4) act scales."""
    def q(w, axes):
        s = np.maximum(np.abs(w).max(axis=axes, keepdims=True), 1e-8) / 127.0
        return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
            s.astype(np.float32)

    heads = [q(p[k], (2,)) for k in ("wq", "wk", "wv")]
    mats = [q(p[k], (1,)) for k in ("w_msa", "w_up", "w_down")]
    acts = np.tile(np.array([3.0, 1.5, 3.0, 2.5], np.float32) / 127.0, (L, 1))
    n_l, h, _, dh = p["wq"].shape
    return ([v for v, _ in heads] + [v for v, _ in mats] + [acts]
            + [s.reshape(n_l, h, dh) for _, s in heads]
            + [s.reshape(n_l, -1) for _, s in mats]
            + [p[k] for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up",
                              "b_down")])


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("mode", ["global", "windowed", "pruned"])
def test_group_float_matches_pallas(mode):
    x, p, bias, mask = _group_case(mode)
    ops_ = [p[k] for k in _ORDER]
    want = np.asarray(j_group(jnp.asarray(x), *map(jnp.asarray, ops_),
                              _opt(bias, jnp.asarray), _opt(mask, jnp.asarray),
                              interpret=True))
    got = ops.vita_layer_group(torch.from_numpy(x),
                               *map(torch.from_numpy, ops_),
                               _opt(bias, torch.from_numpy),
                               _opt(mask, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["global", "windowed", "pruned"])
def test_group_int8_matches_pallas(mode):
    x, p, bias, mask = _group_case(mode, seed=1)
    ops_ = _quantized(p)
    want = np.asarray(j_group_int8(
        jnp.asarray(x), *map(jnp.asarray, ops_), _opt(bias, jnp.asarray),
        _opt(mask, jnp.asarray), interpret=True))
    got = ops.vita_layer_group_int8(
        torch.from_numpy(x), *map(torch.from_numpy, ops_),
        _opt(bias, torch.from_numpy), _opt(mask, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-2 * np.abs(want).max())
    assert np.mean(np.abs(got - want) <= 1e-4) > 0.9


def test_group_ref_is_the_per_layer_chain():
    x, p, bias, mask = _group_case("windowed", seed=2)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    xb, bb, mb = map(torch.from_numpy, (x, bias, mask))
    y = xb
    for l in range(L):
        y = ref.vita_layer_ref(y, *[t[k][l] for k in _ORDER], bb[l], mb)
    assert torch.equal(ref.vita_layer_group_ref(
        xb, *[t[k] for k in _ORDER], bb, mb), y)


# ---------------------------------------------------------------------------
# Grouped against per-layer execution, policy, server and CLI (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,group", [("vit_edge", 3), ("deit_t", 4),
                                        ("swin_t", 4), ("deit_t_p", 4)])
def test_grouped_equals_per_layer_on_the_cpu(name, group):
    cfg = t_reg.build_cfg(name)
    grouped = dataclasses.replace(cfg, fuse_group=group)
    assert "layer_group" in t_reg.make_schedule(grouped).counts()
    params = t_reg.init_params(cfg, seed=0)
    images = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, cfg.image, cfg.image, 3)).astype(np.float32))
    patches = t_vit.extract_patches(images, cfg.patch)
    fwd = t_reg.forward_fn(cfg)
    want, got = fwd(params, patches, cfg), fwd(params, patches, grouped)
    assert float((got - want).abs().max()) <= \
        1e-6 * float(want.abs().max())
    qparams = t_reg.quantize(params)
    cal = t_serve.calibrate(qparams, grouped, images.numpy(), device="cpu",
                            n_batches=1)
    assert torch.equal(fwd(qparams, patches, grouped, observer=cal),
                       fwd(qparams, patches, cfg, observer=cal))


def test_group_operands_are_stacked_once():
    cfg = t_reg.build_cfg("vit_edge", fuse_group=4)
    params = t_reg.init_params(cfg, seed=0)
    (grp,) = [p for p in t_reg.make_schedule(cfg).phases
              if p.kind == "layer_group"]
    first = t_sched._group_operands(grp, params)
    assert t_sched._group_operands(grp, params) is first
    assert first["wq"].shape == (4, cfg.heads, cfg.dim, cfg.head_dim)
    qfirst = t_sched._group_operands(grp, t_reg.quantize(params))
    assert qfirst is not first and qfirst["wq"].values.dtype == torch.int8
    cal = Calibrator()
    cal.amax = {"a": 1.0, "b": 2.0}
    cal.freeze()
    assert cal.stacked(("a", "b")) is cal.stacked(("a", "b"))


def test_policy_group_decision_serves_a_layer_group():
    policy = t_sched.FusionPolicy(
        mode="auto", measurements={("deit_t", "float", 4): 1.05},
        group_measurements={("deit_t", "float", 4): (1.3, 4)})
    server = t_serve.make_server("deit_t", t_serve.ServeConfig(
        buckets=(1, 4), fusion_policy=policy, device="cpu"))
    assert t_reg.make_schedule(server._bucket_cfg[4]).counts() == {
        "embed": 1, "layer_group": 1, "head": 1}
    server.submit_many(np.zeros((4, 64, 64, 3), np.float32))
    stats = server.run()
    assert stats["group_buckets"] == {"1": 4, "4": 4}
    assert stats["fused_buckets"] == {"1": True, "4": True}
    never = t_serve.make_server("deit_t", t_serve.ServeConfig(
        buckets=(4,), fusion_policy=t_sched.FusionPolicy(
            mode="never", default_group=4), device="cpu"))
    assert "msa" in t_reg.make_schedule(never._bucket_cfg[4]).counts()
    never.submit_many(np.zeros((1, 64, 64, 3), np.float32))
    stats = never.run()
    assert stats["fused_buckets"] == {"4": False}
    assert stats["group_buckets"] == {"4": 1}
    with pytest.raises(ValueError):
        t_serve.ServeConfig(fuse_group=0)


def test_cli_fuse_group_size(capsys):
    rows = t_cli.main(["--vision", "--model", "deit_t", "--requests", "3",
                       "--buckets", "1,2", "--fuse-group-size", "4",
                       "--device", "cpu"])
    assert [r["group_buckets"] for r in rows] == [{"1": 4, "2": 4}] * 2
    assert "group sizes {'1': 4, '2': 4}" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="fuse-group-size"):
        t_cli.main(["--vision", "--model", "deit_t",
                    "--fuse-group-size", "0", "--device", "cpu"])
