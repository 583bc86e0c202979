"""The unfused executor's kernels and the windowed mode, held against the
JAX package: the port's plain versions of `vita_msa_batched`,
`fused_mlp`, the windowed `vita_layer` / `vita_layer_int8` and the
windowed `vita_msa_int8` with ``qkv_bias`` against the Pallas kernels
(interpret mode) on the same numpy inputs; the window geometry, the
compiled schedules and `FusionPolicy`'s decisions against the reference.

Shapes are small and ragged: B 2, N 17 (global) and a 4x4 window over an
8x8 grid (nW 4, n 16, half-window shift).  Tolerances: float results
differ by fp32 reassociation only, hence 1e-5; the int8 MSA takes
identical int8 inputs and differs by the fp32 softmax only (1e-5); an
int8 layer may flip a requant code by one LSB where fp32 reassociation
crosses a rounding boundary (2% of the output scale, on under 1% of the
outputs)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as j_sched
from repro.kernels.fused_mlp import fused_mlp as j_fused_mlp
from repro.kernels.vita_layer import vita_layer as j_vita_layer
from repro.kernels.vita_layer import vita_layer_int8 as j_vita_layer_int8
from repro.kernels.vita_msa import vita_msa as j_vita_msa
from repro.kernels.vita_msa import vita_msa_batched as j_vita_msa_batched
from repro.kernels.vita_msa import vita_msa_int8 as j_vita_msa_int8
from repro.models import vision_registry as j_reg
from repro_torch.core import schedule as t_sched
from repro_torch.kernels import ops
from repro_torch.models import vision_registry as t_reg

# Global mode: vit_edge's head width on a non-power-of-two token count.
B, N, D, H = 2, 17, 96, 4
DH = D // H
# Windowed mode: an 8x8 grid of 4x4 windows, shifted by half a window.
GRID, WIN, SHIFT = 8, 4, 2
NW, NWIN = (GRID // WIN) ** 2, WIN * WIN
WD, WH, WM = 32, 2, 64
WDH = WD // WH


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _window_terms(rng, h):
    """(H, n, n) bias from a relative-position table and the shifted
    (nW, n, n) mask, as the executor forms them."""
    table = _f32(rng, (2 * WIN - 1) ** 2, h, scale=0.5)
    bias = table[t_sched.rel_pos_index(WIN)].transpose(2, 0, 1)
    mask = t_sched.shifted_window_mask(GRID, GRID, WIN, SHIFT)
    assert (mask < 0).any()
    return np.ascontiguousarray(bias), mask


def _msa_case(mode, rng):
    """(z, wq, wk, wv, bias, mask, qkv_bias) for one MSA mode."""
    if mode == "global":
        b, n, d, h, dh = B, N, D, H, DH
    else:
        b, n, d, h, dh = B * NW, NWIN, WD, WH, WDH
    z = _f32(rng, b, n, d, scale=0.5)
    ws = [_f32(rng, h, d, dh, scale=d ** -0.5) for _ in range(3)]
    bias, mask = _window_terms(rng, h) if mode != "global" else (None, None)
    qb = _f32(rng, 3, h, dh, scale=0.2) if "qkv_bias" in mode else None
    return z, *ws, bias, mask, qb


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("mode", ["global", "windowed", "windowed_qkv_bias",
                                  "global_qkv_bias"])
def test_vita_msa_batched_matches_pallas(mode):
    args = _msa_case(mode, _rng(10))
    want = np.asarray(j_vita_msa_batched(*map(_j, args), interpret=True))
    got = ops.vita_msa_batched(*map(_tt, args))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vita_msa_single_image_matches_pallas():
    z, wq, wk, wv, *_ = _msa_case("global", _rng(11))
    want = np.asarray(j_vita_msa(*map(jnp.asarray, (z[0], wq, wk, wv)),
                                 interpret=True))
    got = ops.vita_msa(*map(_t, (z[0], wq, wk, wv)))
    assert got.shape == (H, N, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_windowed_mask_keeps_regions_apart():
    """A key the mask forbids has no influence on the query: perturbing it
    leaves that query's output unchanged, as in the reference."""
    z, wq, wk, wv, bias, mask, _ = _msa_case("windowed", _rng(12))
    # window 3 of image 0 holds 4 regions after the shift; find a
    # forbidden (query, key) pair there
    q, k = np.argwhere(mask[3] < 0)[0]
    base = ops.vita_msa_batched(*map(_tt, (z, wq, wk, wv, bias, mask)))
    z2 = z.copy()
    z2[3, k] += 5.0
    out = ops.vita_msa_batched(*map(_tt, (z2, wq, wk, wv, bias, mask)))
    torch.testing.assert_close(out[3, :, q], base[3, :, q])
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("biases", [True, False])
@pytest.mark.parametrize("rows", [(B, N), (3 * N,)])
def test_fused_mlp_matches_pallas(biases, rows):
    rng = _rng(13)
    m = 4 * D
    x = _f32(rng, *rows, D)
    w1, w2 = _f32(rng, D, m, scale=D ** -0.5), _f32(rng, m, D,
                                                     scale=m ** -0.5)
    b1 = _f32(rng, m, scale=0.1) if biases else None
    b2 = _f32(rng, D, scale=0.1) if biases else None
    want = np.asarray(j_fused_mlp(*map(_j, (x, w1, w2, b1, b2)),
                                  interpret=True))
    got = ops.mlp(*map(_tt, (x, w1, w2, b1, b2)), activation="gelu")
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unported_modes_raise():
    """bf16 z with float32 weights is no ported dtype mode of the MSA and
    raises (the ported bf16 modes are `test_torch_bf16.py`'s).  The MLP's
    other activations and its gate are ported (their parity is
    `test_torch_lm_kernels.py`'s); an activation the MLP does not know
    raises."""
    rng = _rng(14)
    x, w1, w2 = (_t(_f32(rng, 4, 8)), _t(_f32(rng, 8, 16)),
                 _t(_f32(rng, 16, 8)))
    with pytest.raises(ValueError, match="unknown activation"):
        ops.mlp(x, w1, w2, activation="tanh")
    torch.testing.assert_close(ops.mlp(x, w1, w2, activation="relu"),
                               torch.relu(x @ w1) @ w2)
    z, wq, wk, wv, *_ = map(_tt, _msa_case("global", rng))
    with pytest.raises(NotImplementedError):
        ops.vita_msa_batched(z.bfloat16(), wq, wk, wv)
    with pytest.raises(ValueError, match="both bias and mask"):
        ops.vita_msa_batched(z, wq, wk, wv, bias=torch.zeros(H, N, N))


def _layer_params(rng, d, h, m):
    dh = d // h
    return dict(
        wq=_f32(rng, h, d, dh, scale=d ** -0.5),
        wk=_f32(rng, h, d, dh, scale=d ** -0.5),
        wv=_f32(rng, h, d, dh, scale=d ** -0.5),
        w_msa=_f32(rng, d, d, scale=d ** -0.5),
        ln1_w=1 + _f32(rng, d, scale=0.1), ln1_b=_f32(rng, d, scale=0.1),
        ln2_w=1 + _f32(rng, d, scale=0.1), ln2_b=_f32(rng, d, scale=0.1),
        w_up=_f32(rng, d, m, scale=d ** -0.5), b_up=_f32(rng, m, scale=0.1),
        w_down=_f32(rng, m, d, scale=m ** -0.5),
        b_down=_f32(rng, d, scale=0.1))


_ORDER = ("wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
          "w_up", "b_up", "w_down", "b_down")


def test_vita_layer_windowed_matches_pallas():
    rng = _rng(15)
    x = _f32(rng, B * NW, NWIN, WD)
    p = _layer_params(rng, WD, WH, WM)
    bias, mask = _window_terms(rng, WH)
    want = np.asarray(j_vita_layer(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in _ORDER),
        jnp.asarray(bias), jnp.asarray(mask), interpret=True))
    got = ops.vita_layer_fused(_t(x), *(_t(p[k]) for k in _ORDER),
                               _t(bias), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vita_layer_int8_windowed_matches_pallas():
    rng = _rng(16)
    x = _f32(rng, B * NW, NWIN, WD)
    p = _layer_params(rng, WD, WH, WM)
    bias, mask = _window_terms(rng, WH)

    def per_head(w):
        s = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-8) / 127.0
        return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
            s.astype(np.float32).reshape(WH, WDH)

    def per_channel(w):
        s = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
            s.astype(np.float32)

    heads = [per_head(p[k]) for k in ("wq", "wk", "wv")]
    mats = [per_channel(p[k]) for k in ("w_msa", "w_up", "w_down")]
    acts = np.array([3.0, 1.5, 3.0, 2.5], np.float32) / 127.0
    args = ([w for w, _ in heads] + [w for w, _ in mats] + [acts]
            + [s for _, s in heads] + [s for _, s in mats]
            + [p[k] for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up",
                              "b_down")] + [bias, mask])
    want = np.asarray(j_vita_layer_int8(jnp.asarray(x),
                                        *map(jnp.asarray, args),
                                        interpret=True))
    got = ops.vita_layer_int8(_t(x), *map(_t, args)).numpy()
    # As in the global test: fp32 reassociation, plus at most a rare
    # single-LSB requant flip worth one activation scale times a weight.
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-2 * np.abs(want).max())
    assert np.mean(np.abs(got - want) <= 1e-4) > 0.99


@pytest.mark.parametrize("windowed", [False, True])
def test_vita_msa_int8_qkv_bias_matches_pallas(windowed):
    rng = _rng(17)
    b, n, d, h = (B * NW, NWIN, WD, WH) if windowed else (B, N, D, H)
    dh = d // h
    z = _i8(rng, b, n, d)
    ws = [_i8(rng, h, d, dh) for _ in range(3)]
    sc = [rng.uniform(2e-4, 1e-3, size=(h, dh)).astype(np.float32)
          for _ in range(3)]
    xs = np.float32(0.021)
    qb = _f32(rng, 3, h, dh, scale=0.2)
    bias, mask = _window_terms(rng, h) if windowed else (None, None)
    args = (z, *ws, xs, *sc, bias, mask, qb)
    want = np.asarray(j_vita_msa_int8(*map(_j, args), interpret=True))
    got = ops.vita_msa_int8(*map(_tt, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Window geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("win", [4, 7])
def test_window_partition_round_trip_matches_jax(win):
    x = _f32(_rng(18), 2, 2 * win, 3 * win, 5)
    got = t_sched.window_partition(_t(x), win)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_sched.window_partition(jnp.asarray(x),
                                                         win)))
    assert got.is_contiguous()
    back = t_sched.window_reverse(got, win, 2 * win, 3 * win)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("grid,win,shift", [(8, 4, 2), (8, 4, 0),
                                            (14, 7, 3), (56, 7, 3)])
def test_window_tables_match_jax(grid, win, shift):
    np.testing.assert_array_equal(t_sched.rel_pos_index(win),
                                  j_sched.rel_pos_index(win))
    got = t_sched.shifted_window_mask(grid, grid, win, shift)
    want = j_sched.shifted_window_mask(grid, grid, win, shift)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert t_sched.NEG_INF == j_sched.NEG_INF


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

_FIELDS = ("kind", "path", "site", "grid", "heads", "window", "shift",
           "pos_embed", "norm")


def _rows(sched):
    return [tuple(getattr(p, f) for f in _FIELDS) for p in sched.phases]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", ["swin_t", "deit_t"])
def test_schedule_matches_jax(name, full, fused):
    t_cfg = t_reg.build_cfg(name, full=full, fused=fused)
    j_cfg = j_reg.build_cfg(name, full=full, fused=fused)
    got = t_reg.make_schedule(t_cfg)
    assert _rows(got) == _rows(j_reg.make_schedule(j_cfg))
    kinds = got.counts()
    blocks = sum(t_cfg.depths) if name == "swin_t" else t_cfg.layers
    if fused:
        assert kinds["layer"] == blocks and "msa" not in kinds
    else:
        assert kinds["msa"] == kinds["mlp"] == blocks
    if name == "swin_t":
        assert kinds["merge"] == len(t_cfg.depths) - 1
        assert any(p.shift for p in got.phases)


def test_tnt_and_layer_groups_raise():
    """TNT's inner blocks are ported: the spec compiles into JAX's
    dual-stream phases, and an ``inner_layer_group`` phase runs.  What
    still raises: inner blocks under the hierarchical layout (JAX
    asserts; the port raises ValueError) and an inner phase kind that has
    no outer twin."""
    from repro.core import schedule as j_sched
    from repro.core.perfmodel import StageSpec as JStageSpec
    from repro.core.perfmodel import VisionModelSpec as JVisionModelSpec
    from repro_torch.core.perfmodel import StageSpec, VisionModelSpec
    stage = dict(layers=1, dim=32, heads=2, tokens=16, inner_tokens=4,
                 inner_dim=8, inner_heads=2)
    spec = VisionModelSpec(name="t", image=(32, 32, 3), patch=8,
                           stages=(StageSpec(**stage),), embed_dim=32)
    j_spec = JVisionModelSpec(name="t", image=(32, 32, 3), patch=8,
                              stages=(JStageSpec(**stage),), embed_dim=32)
    got = t_sched.compile_schedule(spec, n_classes=10)
    want = j_sched.compile_schedule(j_spec, n_classes=10)
    assert [(p.kind, p.path, p.site, p.grid, p.heads, p.inner_tokens)
            for p in got.phases] == [
        (p.kind, p.path, p.site, p.grid, p.heads, p.inner_tokens)
        for p in want.phases]
    with pytest.raises(ValueError):
        t_sched.compile_schedule(spec, n_classes=10, hierarchical=True)
    grouped = t_sched.fuse_schedule(
        t_reg.make_schedule(t_reg.build_cfg("swin_t")), group_size=2)
    assert grouped.counts()["layer_group"] == 1
    inner = dataclasses.replace(
        [p for p in grouped.phases if p.kind == "layer_group"][0],
        kind="inner_merge")
    with pytest.raises(NotImplementedError):
        t_sched.run_schedule(dataclasses.replace(grouped, phases=(inner,)),
                             {"patch_embed": None}, torch.zeros(1, 49, 96))


# ---------------------------------------------------------------------------
# Fusion policy
# ---------------------------------------------------------------------------

BENCH = {"bench": "vision_serve", "runs": [
    {"model": "m", "mode": "float", "batch": 1, "fused": True,
     "fusion_speedup": 1.21},
    {"model": "m", "mode": "float", "batch": 1, "fused": False},
    {"model": "m", "mode": "float", "batch": 4, "fused": True,
     "fusion_speedup": 0.80},
    {"model": "m", "mode": "int8", "batch": 4, "fused": True,
     "group_size": 1, "fusion_speedup": 1.05},
    {"model": "m", "mode": "int8", "batch": 4, "fused": True,
     "group_size": 4, "fusion_speedup": 0.90},
    {"model": "m", "mode": "int8", "batch": 1, "fused": True,
     "group_size": 4, "fusion_speedup": 1.30},
    {"model": "m", "mode": "float", "batch": 8, "fused": True},
]}


@pytest.mark.parametrize("kw", [{}, {"threshold": 1.1}, {"default_group": 2},
                                {"default_fused": False}])
def test_fusion_policy_decides_as_jax(kw, tmp_path):
    import json
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(BENCH))
    for mode in ("auto", "always", "never"):
        got = t_sched.FusionPolicy.from_bench(str(path), mode=mode, **kw)
        want = j_sched.FusionPolicy.from_bench(BENCH, mode=mode, **kw)
        assert got.measurements == want.measurements
        assert got.group_measurements == want.group_measurements
        for model in ("m", "other"):
            for m in ("float", "int8"):
                batches = (1, 2, 3, 4, 8)
                assert got.decisions(model, m, batches) == \
                    want.decisions(model, m, batches)
                assert got.group_decisions(model, m, batches) == \
                    want.group_decisions(model, m, batches)
    with pytest.raises(ValueError):
        t_sched.FusionPolicy(mode="sometimes")
    assert dataclasses.is_dataclass(t_sched.FusionPolicy())
