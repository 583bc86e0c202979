"""TNT-S and its pruned variant in the port, held against the JAX package
on the same weights (JAX's seeded init, carried across with
`repro_torch.convert.params_from_numpy`) and the same numpy images: the
pixel partition, the compiled dual-stream schedule, the init layout,
quantisation, calibration, the model forward fused and unfused, the dense
oracle, the server and CLI on the CPU, and bf16 weights.

Models run at their reduced geometry (``tnt_edge``: 32 px, a 4x4 grid of
8 px patches, each of 4 sub-patches, 2 layers), the schedules also at
full TNT-S (compile only).  Tolerances as in tests/test_torch_swin.py:
float logits within 1e-4 of the logit scale (fp32 reassociation); int8
logits at JAX's frozen scales with equal argmax and within 2% of the logit
scale, since a single-LSB requant flip at a rounding boundary moves a
logit by about one activation scale times a weight; bf16 at
tests/test_torch_bf16.py's (1e-4 in mixed mode, 2e-2 in bf16)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as j_sched
from repro.launch import vision_serve as j_serve
from repro.models import tnt as j_tnt
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.core import schedule as t_sched
from repro_torch.kernels import ops
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import tnt as t_tnt
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

from test_torch_swin import _leaves, _qtensors

NAMES = ("tnt_s", "tnt_s_p")
_FIELDS = ("kind", "path", "site", "grid", "heads", "window", "shift",
           "pos_embed", "norm", "inner_tokens")
SCHEDULES = {"fused": dict(fused=True, fuse_group=1),
             "unfused": dict(fused=False, fuse_group=1),
             "grouped by 2": dict(fused=True, fuse_group=2)}


@functools.lru_cache(maxsize=None)
def _setup(name: str):
    """JAX cfg/params/int8 params/frozen calibrator, and 3 images."""
    cfg = j_reg.build_cfg(name)
    params = j_reg.init_params(jax.random.PRNGKey(0), cfg)
    qparams = j_reg.quantize(params)
    images = np.random.default_rng(7).standard_normal(
        (3, cfg.image, cfg.image, 3)).astype(np.float32)
    cal = j_serve.calibrate(qparams, cfg, images, n_batches=2)
    return cfg, params, qparams, cal, images


def _patches_j(cfg, images):
    return j_vit.extract_patches(jnp.asarray(images), cfg.patch)


def _patches_t(cfg, images):
    return t_vit.extract_patches(torch.from_numpy(images), cfg.patch)


# ---------------------------------------------------------------------------
# The control program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,patch,m", [(2, 16, 8, 4), (1, 4, 16, 16),
                                         (3, 9, 12, 9)])
def test_pixel_partition_matches_jax_exactly(b, n, patch, m):
    x = np.random.default_rng(b * n).standard_normal(
        (b, n, patch * patch * 3)).astype(np.float32)
    want = np.asarray(j_sched.pixel_partition(jnp.asarray(x), m))
    got = t_sched.pixel_partition(torch.from_numpy(x), m)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_pixel_partition_refuses_what_jax_asserts():
    with pytest.raises(ValueError, match="square"):
        t_sched.pixel_partition(torch.zeros(1, 4, 192), 8)
    with pytest.raises(ValueError, match="P\\*P\\*3"):
        t_sched.pixel_partition(torch.zeros(1, 4, 100), 4)
    with pytest.raises(ValueError, match="divisible"):
        t_sched.pixel_partition(torch.zeros(1, 4, 3 * 25), 4)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_jax(name, full, schedule):
    """Kind, path, site, grid, heads and inner_tokens of every phase, as
    JAX compiles them; fused TNT pairs both streams, and grouping forms
    no group (a fold sits between every two layers of a stream)."""
    kw = SCHEDULES[schedule]
    t_cfg = t_reg.build_cfg(name, full=full, **kw)
    j_cfg = j_reg.build_cfg(name, full=full, **kw)
    got = t_reg.make_schedule(t_cfg)
    want = j_reg.make_schedule(j_cfg)
    rows = [tuple(getattr(p, f) for f in _FIELDS) for p in got.phases]
    assert rows == [tuple(getattr(p, f) for f in _FIELDS)
                    for p in want.phases]
    counts = got.counts()
    layers = t_cfg.layers
    assert counts["fold"] == layers and counts["embed"] == counts["head"] == 1
    if kw["fused"]:
        assert counts["inner_layer"] == counts["layer"] == layers
        assert got == t_reg.make_schedule(
            dataclasses.replace(t_cfg, fuse_group=1))
    else:
        assert all(counts[k] == layers for k in ("inner_msa", "inner_mlp",
                                                 "msa", "mlp"))
    embed = got.phases[0]
    assert embed.inner_tokens == t_cfg.inner_tokens and embed.norm


def test_tnt_specs_the_compiler_refuses():
    """A TNT stage only as the columnar first stage with a square inner
    grid (JAX asserts, the port raises ValueError); a hand-edited phase of
    an unported inner kind raises."""
    from repro_torch.core.perfmodel import StageSpec, VisionModelSpec

    def spec(*stages, image=32):
        return VisionModelSpec(name="t", image=(image, image, 3), patch=8,
                               stages=stages, embed_dim=32)

    inner = dict(inner_dim=8, inner_heads=2)
    with pytest.raises(ValueError, match="not square"):
        t_sched.compile_schedule(spec(StageSpec(
            layers=1, dim=32, heads=2, tokens=16, inner_tokens=6, **inner)),
            n_classes=10)
    with pytest.raises(ValueError, match="columnar"):
        t_sched.compile_schedule(spec(StageSpec(
            layers=1, dim=32, heads=2, tokens=16, inner_tokens=4, **inner)),
            n_classes=10, hierarchical=True)
    sched = t_reg.make_schedule(t_reg.build_cfg("tnt_s"))
    bad = dataclasses.replace(sched.phases[2], kind="inner_merge")
    with pytest.raises(NotImplementedError):
        t_sched.run_schedule(dataclasses.replace(sched, phases=(bad,)),
                             {"patch_embed": None}, torch.zeros(1, 16, 192))


def test_hand_made_inner_layer_group_equals_the_per_layer_chain():
    """``inner_layer_group`` (GROUPABLE_KINDS): the grouping pass forms
    none even where a hand-edited schedule puts tnt_edge's two inner
    layers side by side (their paths differ before the trailing
    ``inner``), as JAX's pass; a group phase made by hand runs the
    layer-group kernel's plain version on the inner stream and equals the
    per-layer chain."""
    cfg = t_reg.build_cfg("tnt_s")
    params = t_tnt.init_params(cfg, seed=2)
    sched = t_reg.make_schedule(cfg)
    inner = [p for p in sched.phases if p.kind == "inner_layer"]
    rest = [p for p in sched.phases if p.kind != "inner_layer"]
    edited = dataclasses.replace(sched, phases=tuple(rest[:1] + inner
                                                     + rest[1:]))
    assert t_sched.fuse_schedule(edited, group_size=2) == edited
    j_sched_ = j_reg.make_schedule(j_reg.build_cfg("tnt_s"))
    j_inner = [p for p in j_sched_.phases if p.kind == "inner_layer"]
    j_rest = [p for p in j_sched_.phases if p.kind != "inner_layer"]
    j_edited = dataclasses.replace(j_sched_, phases=tuple(
        j_rest[:1] + j_inner + j_rest[1:]))
    assert j_sched.fuse_schedule(j_edited, group_size=2) == j_edited
    group = dataclasses.replace(inner[0], kind="inner_layer_group",
                                members=tuple(inner))
    grouped = dataclasses.replace(edited, phases=tuple(
        rest[:1] + [group] + rest[1:]))
    images = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    patches = _patches_t(cfg, images)
    ops.reset_launches()
    got = t_sched.run_schedule(grouped, params, patches)
    want = t_sched.run_schedule(edited, params, patches)
    assert not any(ops.LAUNCHES.values())       # CPU: plain versions only
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Params, quantisation, calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_tnt_init_params_has_the_jax_layout(name):
    cfg = t_reg.build_cfg(name, full=True)
    j_cfg = j_reg.build_cfg(name, full=True)
    assert cfg.head_mask == j_cfg.head_mask
    got = dict(_leaves(t_reg.init_params(cfg, seed=0)))
    want = dict(_leaves(jax.eval_shape(
        lambda: j_reg.init_params(jax.random.PRNGKey(0), j_cfg))))
    assert got == want
    a = t_tnt.init_params(t_reg.build_cfg(name), seed=3)
    b = t_tnt.init_params(t_reg.build_cfg(name), seed=3)
    assert torch.equal(a["inner_pos_embed"], b["inner_pos_embed"])
    assert torch.equal(a["layers"][1]["fold_w"], b["layers"][1]["fold_w"])


def test_pruned_tnt_slices_the_outer_stream_only():
    dense = t_tnt.init_params(t_reg.build_cfg("tnt_s"), seed=3)
    pruned = t_tnt.init_params(t_reg.build_cfg("tnt_s_p"), seed=3)
    for li, keep in enumerate(([0, 1, 2], [1, 3])):
        outer = pruned["layers"][li]["outer"]
        assert torch.equal(outer["wq"], dense["layers"][li]["outer"]["wq"]
                           [keep])
        assert outer["w_msa"].shape[0] == len(keep) * outer["wq"].shape[2]
        for k, v in dense["layers"][li]["inner"].items():
            assert torch.equal(pruned["layers"][li]["inner"][k], v)


@pytest.mark.parametrize("name", NAMES)
def test_quantize_tnt_matches_jax_exactly(name):
    _, params, qparams, _, _ = _setup(name)
    got = dict(_qtensors(t_tnt.quantize_tnt(params_from_numpy(params))))
    want = dict(_qtensors(qparams))
    n_layers = len(params["layers"])
    assert got.keys() == want.keys()
    # pixel_embed, patch_embed, head; per layer the fold and 6 a block
    assert len(want) == 3 + 13 * n_layers
    assert ("layers", 0, "inner", "wq") in want
    assert ("layers", 1, "fold_w") in want
    for path, q in want.items():
        np.testing.assert_array_equal(got[path].values.numpy(),
                                      np.asarray(q.values), err_msg=str(path))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(q.scale), err_msg=str(path))


@pytest.mark.parametrize("name", NAMES)
def test_tnt_calibrator_scales_match_jax(name):
    """Every site is recorded under JAX's name, and each scale agrees.
    The sites that see the unquantised input agree exactly; downstream of
    the first requant a single-LSB flip where fp32 reassociation crosses a
    rounding boundary moves later activations by about one activation
    scale times a weight, hence 1e-2 (as for Swin)."""
    _, _, qparams, cal, images = _setup(name)
    t_cal = t_serve.calibrate(params_from_numpy(qparams),
                              t_reg.build_cfg(name), images, device="cpu",
                              n_batches=2)
    assert t_cal.frozen.keys() == cal.frozen.keys()
    for site in ("pixel_embed", "patch_embed", "l0.inner.qkv_in",
                 "l0.inner.w_down", "l0.fold", "l1.w_msa", "head"):
        assert site in cal.frozen, site
    assert float(t_cal.frozen["pixel_embed"]) == float(
        cal.frozen["pixel_embed"])
    for k, v in cal.frozen.items():
        np.testing.assert_allclose(float(t_cal.frozen[k]), float(v),
                                   rtol=1e-2, err_msg=k)


def test_calibrator_from_jax_scales_carries_every_tnt_site():
    _, _, _, cal, _ = _setup("tnt_s")
    t_cal = calibrator_from_scales(cal.frozen)
    assert t_cal.frozen.keys() == cal.frozen.keys()
    for k, v in cal.frozen.items():
        assert t_cal.frozen[k].dtype == torch.float32
        assert float(t_cal.frozen[k]) == float(np.float32(v)), k


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_forward_float_matches_jax(name, fused):
    cfg, params, _, _, images = _setup(name)
    cfg = dataclasses.replace(cfg, fused=fused)
    want = np.asarray(j_reg.forward_fn(cfg)(params, _patches_j(cfg, images),
                                            cfg))
    t_cfg = t_reg.build_cfg(name, fused=fused)
    got = t_reg.forward_fn(t_cfg)(params_from_numpy(params),
                                  _patches_t(t_cfg, images), t_cfg).numpy()
    assert got.shape == (3, 10)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, scale))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_forward_int8_matches_jax(name, fused):
    cfg, _, qparams, cal, images = _setup(name)
    cfg = dataclasses.replace(cfg, fused=fused)
    want = np.asarray(j_reg.forward_fn(cfg)(
        qparams, _patches_j(cfg, images), cfg, observer=cal))
    t_cfg = t_reg.build_cfg(name, fused=fused)
    got = t_reg.forward_fn(t_cfg)(
        params_from_numpy(qparams), _patches_t(t_cfg, images), t_cfg,
        observer=calibrator_from_scales(cal.frozen)).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_tnt_reference_forward_matches_jax_and_the_schedule(name):
    cfg, params, _, _, images = _setup(name)
    want = np.asarray(j_tnt.reference_forward(
        params, _patches_j(cfg, images), cfg))
    t_cfg = t_reg.build_cfg(name)
    tp = params_from_numpy(params)
    got = t_tnt.reference_forward(tp, _patches_t(t_cfg, images), t_cfg)
    atol = 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    for fused in (True, False):
        c = dataclasses.replace(t_cfg, fused=fused)
        sched = t_tnt.forward(tp, _patches_t(c, images), c)
        np.testing.assert_allclose(sched.numpy(), got.numpy(), rtol=0,
                                   atol=atol)


def test_forward_on_the_cpu_launches_no_kernel_and_counts_the_phases():
    cfg = t_reg.build_cfg("tnt_s")
    params = t_tnt.init_params(cfg, seed=0)
    images = np.zeros((2, 32, 32, 3), np.float32)
    ops.reset_launches()
    logits = t_tnt.forward(params, _patches_t(cfg, images), cfg)
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    assert not any(ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# bf16 weights
# ---------------------------------------------------------------------------

_ACT = {"mixed": (np.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}
_BF16_TOL = {"mixed": 1e-4, "bf16": 2e-2}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("mode", sorted(_ACT))
def test_bf16_forward_matches_jax(mode, fused):
    """tnt_edge with every weight bf16, on float32 patches (mixed) and
    bf16 patches, against JAX's `forward` on the same config; the unfused
    bf16 MSA runs JAX's fp32-accumulating oracle (the ``xla`` backend),
    which JAX's CPU backend needs (tests/test_torch_bf16.py)."""
    backend = "xla" if (mode, fused) == ("bf16", False) else "pallas"
    j_cfg = dataclasses.replace(j_reg.build_cfg("tnt_s"), dtype="bfloat16",
                                fused=fused, backend=backend)
    t_cfg = dataclasses.replace(t_reg.build_cfg("tnt_s"), dtype="bfloat16",
                                fused=fused)
    params = j_reg.init_params(jax.random.PRNGKey(0), j_cfg)
    images = np.random.default_rng(7).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    patches = np.array(_patches_j(j_cfg, images))
    jdt, tdt = _ACT[mode]
    want = j_reg.forward_fn(j_cfg)(params, jnp.asarray(patches).astype(jdt),
                                   j_cfg)
    got = t_reg.forward_fn(t_cfg)(params_from_numpy(params),
                                  torch.from_numpy(patches).to(tdt), t_cfg)
    assert got.dtype == tdt
    w = np.asarray(want).astype(np.float32)
    err = float(np.abs(got.float().numpy() - w).max())
    assert err <= _BF16_TOL[mode] * max(1.0, float(np.abs(w).max())), err


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

BUCKETS = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def _jax_server(name: str, mode: str, fused: bool):
    """The JAX server's logits for 5 images (4 + a ragged 1), and its
    params / int8 params / frozen scales."""
    server = j_serve.make_server(
        name, j_serve.ServeConfig(mode=mode, buckets=BUCKETS,
                                  calib_images=4, fused=fused))
    cfg = server.cfg
    images = np.random.default_rng(3).standard_normal(
        (5, cfg.image, cfg.image, 3)).astype(np.float32)
    reqs = server.submit_many(images)
    server.run()
    scales = server.calibrator.frozen if mode == "int8" else None
    return (np.stack([r.logits for r in reqs]), images, server.params,
            server.qparams, scales)


@pytest.mark.parametrize("name,mode,fused", [
    ("tnt_s", "float", True), ("tnt_s", "int8", True),
    ("tnt_s", "float", False), ("tnt_s", "int8", False),
    ("tnt_s_p", "float", True), ("tnt_s_p", "int8", True)])
def test_server_matches_jax_server(name, mode, fused):
    want, images, params, qparams, scales = _jax_server(name, mode, fused)
    server = t_serve.make_server(
        name, t_serve.ServeConfig(mode=mode, buckets=BUCKETS, fused=fused,
                                  device="cpu"),
        params=params_from_numpy(params),
        qparams=None if qparams is None else params_from_numpy(qparams),
        calibrator=None if scales is None else calibrator_from_scales(scales))
    assert server.cfg.fused is fused
    reqs = server.submit_many(images)
    stats = server.run()
    got = np.stack([r.logits for r in reqs])
    assert got.shape == want.shape == (5, 10)
    assert stats["requests"] == 5 and stats["batches"] == 2
    assert set(stats["fused_buckets"].values()) == {fused}
    if mode == "float":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_make_server_calibrates_tnt_int8_at_jax_sites():
    """int8 without a calibrator: the port quantizes and calibrates on its
    own synthetic bank, recording every site JAX's calibration records."""
    server = t_serve.make_server("tnt_s_p", t_serve.ServeConfig(
        mode="int8", buckets=(1, 2), calib_images=2, device="cpu"))
    _, _, _, cal, _ = _setup("tnt_s_p")
    assert server.calibrator.frozen.keys() == cal.frozen.keys()
    server.submit_many(np.zeros((3, 32, 32, 3), np.float32))
    stats = server.run()
    assert stats["requests"] == 3 and stats["batches"] == 2


def test_cli_serves_tnt_on_the_cpu(capsys):
    rows = t_cli.main(["--vision", "--model", "tnt_s", "--mode", "both",
                       "--requests", "3", "--buckets", "1,2", "--device",
                       "cpu"])
    assert [r["mode"] for r in rows] == ["float", "int8"]
    assert all(r["requests"] == 3 and r["batches"] == 2 for r in rows)
    assert all(all(r["fused_buckets"].values()) for r in rows)
    assert "tnt_edge_32 mode=int8 on cpu" in capsys.readouterr().out
    rows = t_cli.main(["--vision", "--model", "tnt_s_p", "--no-fuse",
                       "--mode", "float", "--requests", "2", "--buckets",
                       "2", "--fuse-group-size", "2", "--device", "cpu"])
    assert rows[0]["fused_buckets"] == {"2": False}
    t_cli.main(["--vision", "--list-models"])
    listing = capsys.readouterr().out
    assert "tnt_s " in listing and "tnt_s_p" in listing and "[tnt]" in listing
