"""Swin-T and the unfused (``--no-fuse``) schedules of the port, held
against the JAX package on the same weights (JAX's seeded init, carried
across with `repro_torch.convert.params_from_numpy`) and the same numpy
images: quantisation, calibration, the model forward fused and unfused,
the dense oracle, and the server and CLI on the CPU.

Models run at their reduced geometry: ``swin_t`` is ``swin_edge`` (56 px,
two stages, four shifted 7x7 windows, one patch merge), ``deit_t`` is
64 px with 4 layers.  Tolerances as in tests/test_torch_model.py: float
logits within 1e-4 of the logit scale (fp32 reassociation); int8 logits
at JAX's frozen scales with equal argmax and within 2% of the logit
scale, since a single-LSB requant flip at a rounding boundary moves a
logit by about one activation scale times a weight."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as j_sched
from repro.launch import vision_serve as j_serve
from repro.models import swin as j_swin
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.core import schedule as t_sched
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import swin as t_swin
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

# (model, fused) pairs this slice adds; fused DeiT-T is PR 11's.
CASES = [("swin_t", True), ("swin_t", False), ("deit_t", False)]


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


def _qtensors(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _qtensors(v, path + (i,))
    elif hasattr(tree, "values") and hasattr(tree, "scale"):
        yield path, tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tuple(tree.shape)


def test_swin_init_params_has_the_jax_layout():
    cfg = t_reg.build_cfg("swin_t", full=True)
    j_cfg = j_reg.build_cfg("swin_t", full=True)
    got = dict(_leaves(t_swin.init_params(cfg, seed=0)))
    want = dict(_leaves(jax.eval_shape(
        lambda: j_reg.init_params(jax.random.PRNGKey(0), j_cfg))))
    assert got == want
    a = t_swin.init_params(t_reg.build_cfg("swin_t"), seed=3)
    b = t_swin.init_params(t_reg.build_cfg("swin_t"), seed=3)
    assert torch.equal(a["stages"][1]["blocks"][0]["rel_bias"],
                       b["stages"][1]["blocks"][0]["rel_bias"])
    mask = (((1, 0, 1), (1, 1, 1)), ((1, 1, 0, 1, 1, 0), (0, 1, 1, 0, 1, 0)))
    pruned = t_swin.init_params(dataclasses.replace(
        t_reg.build_cfg("swin_t"), head_mask=mask), seed=3)
    blk = pruned["stages"][1]["blocks"][1]
    assert blk["wq"].shape[0] == blk["rel_bias"].shape[1] == 3
    assert blk["w_msa"].shape[0] == 3 * blk["wq"].shape[2]
    assert torch.equal(blk["wq"], b["stages"][1]["blocks"][1]["wq"][[1, 2, 4]])


def test_quantize_swin_params_matches_jax_exactly():
    _, params, qparams, _, _ = _setup("swin_t")
    got = dict(_qtensors(t_quant.quantize_vision_params(
        params_from_numpy(params))))
    want = dict(_qtensors(qparams))
    blocks = sum(len(s["blocks"]) for s in params["stages"])
    assert got.keys() == want.keys()
    assert len(want) == 2 + 6 * blocks + len(params["stages"]) - 1
    for path, q in want.items():
        np.testing.assert_array_equal(got[path].values.numpy(),
                                      np.asarray(q.values), err_msg=str(path))
        np.testing.assert_array_equal(got[path].scale.numpy(),
                                      np.asarray(q.scale), err_msg=str(path))


def test_swin_calibrator_scales_match_jax():
    """Every site is recorded, and each scale agrees.  The sites that see
    the unquantised input agree exactly; downstream of the first requant a
    single-LSB flip where fp32 reassociation crosses a rounding boundary
    moves later activations by about one activation scale times a weight,
    and the flips compound over Swin's 4 blocks and merge (6e-3 at worst
    on these inputs), hence 1e-2."""
    _, _, qparams, cal, images = _setup("swin_t")
    t_cal = t_serve.calibrate(params_from_numpy(qparams),
                              t_reg.build_cfg("swin_t"), images,
                              device="cpu", n_batches=2)
    assert t_cal.frozen.keys() == cal.frozen.keys()
    assert "s0.merge" in cal.frozen and "s1.b1.qkv_in" in cal.frozen
    for k in ("patch_embed", "s0.b0.qkv_in"):
        assert float(t_cal.frozen[k]) == float(cal.frozen[k]), k
    for k, v in cal.frozen.items():
        np.testing.assert_allclose(float(t_cal.frozen[k]), float(v),
                                   rtol=1e-2, err_msg=k)


def _patches_j(cfg, images):
    return j_vit.extract_patches(jnp.asarray(images), cfg.patch)


def _patches_t(cfg, images):
    return t_vit.extract_patches(torch.from_numpy(images), cfg.patch)


@pytest.mark.parametrize("name,fused", CASES)
def test_forward_float_matches_jax(name, fused):
    cfg, params, _, _, images = _setup(name)
    cfg = dataclasses.replace(cfg, fused=fused)
    want = np.asarray(j_reg.forward_fn(cfg)(params, _patches_j(cfg, images),
                                            cfg))
    t_cfg = t_reg.build_cfg(name, fused=fused)
    got = t_reg.forward_fn(t_cfg)(params_from_numpy(params),
                                  _patches_t(t_cfg, images), t_cfg).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, scale))


@pytest.mark.parametrize("name,fused", CASES)
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


def test_swin_reference_forward_matches_jax_and_the_schedule():
    cfg, params, _, _, images = _setup("swin_t")
    want = np.asarray(j_swin.reference_forward(
        params, _patches_j(cfg, images), cfg))
    t_cfg = t_reg.build_cfg("swin_t")
    tp = params_from_numpy(params)
    got = t_swin.reference_forward(tp, _patches_t(t_cfg, images), t_cfg)
    atol = 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    sched = t_swin.forward(tp, _patches_t(t_cfg, images), t_cfg)
    np.testing.assert_allclose(sched.numpy(), got.numpy(), rtol=0, atol=atol)


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
    ("swin_t", "float", True), ("swin_t", "int8", True),
    ("swin_t", "float", False), ("deit_t", "float", False),
    ("deit_t", "int8", False)])
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


BENCH = {"bench": "vision_serve", "runs": [
    {"model": "swin_t", "mode": "float", "batch": 1, "fused": True,
     "fusion_speedup": 1.2},
    {"model": "swin_t", "mode": "float", "batch": 4, "fused": True,
     "fusion_speedup": 0.8},
]}


def test_fusion_policy_picks_the_schedule_per_bucket_as_jax_does():
    policy = t_sched.FusionPolicy.from_bench(BENCH)
    server = t_serve.make_server("swin_t", t_serve.ServeConfig(
        buckets=BUCKETS, fusion_policy=policy, device="cpu"))
    j_server = j_serve.VisionServer(
        j_reg.build_cfg("swin_t"), None, serve_cfg=j_serve.ServeConfig(
            buckets=BUCKETS,
            fusion_policy=j_sched.FusionPolicy.from_bench(BENCH)),
        model_name="swin_t")
    got = {b: c.fused for b, c in server._bucket_cfg.items()}
    assert got == j_server._bucket_fused == {1: True, 2: True, 4: False}
    images = np.random.default_rng(5).standard_normal(
        (4, 56, 56, 3)).astype(np.float32)
    unfused = server.forward(torch.from_numpy(images))          # bucket 4
    fused = t_swin.forward(server.params, _patches_t(server.cfg, images),
                           server.cfg)
    torch.testing.assert_close(unfused, fused, rtol=0, atol=1e-4)


def test_cli_serves_swin_unfused_both_modes_on_the_cpu(capsys, tmp_path):
    rows = t_cli.main(["--vision", "--model", "swin_t", "--no-fuse",
                       "--mode", "both", "--requests", "3", "--buckets",
                       "1,2", "--device", "cpu"])
    assert [r["mode"] for r in rows] == ["float", "int8"]
    assert all(r["requests"] == 3 and r["batches"] == 2 for r in rows)
    assert all(not any(r["fused_buckets"].values()) for r in rows)
    assert "swin_edge_56 mode=int8 on cpu" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_cli.main(["--vision", "--model", "swin_t", "--no-fuse",
                    "--fusion-policy", "always", "--device", "cpu"])
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(BENCH))
    rows = t_cli.main(["--vision", "--model", "swin_t", "--mode", "float",
                       "--requests", "2", "--buckets", "1,4",
                       "--fusion-policy", "auto", "--fusion-data",
                       str(path), "--device", "cpu"])
    assert rows[0]["fusion_policy"] == "auto"
    assert rows[0]["fused_buckets"] == {"1": True, "4": False}
