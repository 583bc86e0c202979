"""The bf16 vision configuration (``dtype="bfloat16"``) of the port held
against the JAX package on the CPU, on the same numpy inputs and JAX's
seeded weights (carried across with `convert.params_from_numpy`, which
keeps bf16).

Two dtype modes reach the kernels (`repro_torch.kernels.ref.PORTED_MODES`):
"mixed", float32 activations with bf16 weights (what `VisionServer` runs
on float32 images), and "bf16", bf16 throughout (`forward` on bf16
patches).  The JAX side runs its Pallas kernels in interpret mode, except
the per-head MSA in bf16 (and so the unfused bf16 forward), which jax's
CPU backend cannot run (``DotThunk``: BF16 x BF16 = F32, the reference's
known failure): there it is the fp32-accumulating oracle
`repro.kernels.ref.vita_msa_batched_ref` (the ``xla`` backend).

Tolerances: mixed mode is float32 math on exactly upcast weights on both
sides, so the float tolerances of the existing parity tests hold (1e-5 of
max(1, output scale) per kernel, 1e-4 on logits at a scale of about 1).
bf16 mode rounds to bf16 at places that differ between the frameworks
(the plain products of embed, merge and head, the output of every phase)
and between JAX's MSA oracle and the TPU kernel (P and V, which the
port's plain version rounds as the TPU kernel does), so it is held at
2e-2 of max(1, output scale), the JAX package's own bf16 kernel tolerance
(`tests/test_kernels.py`): a few bf16 ulps.  int8 from bf16 params keeps
the int8 contract: equal argmax and 0.02 of the logit scale.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.fused_mlp import fused_mlp as j_fused_mlp
from repro.kernels.vita_layer import vita_layer as j_vita_layer
from repro.kernels.vita_layer import vita_layer_group as j_group
from repro.kernels.vita_msa import vita_msa_batched as j_vita_msa_batched
from repro.launch import vision_serve as j_serve
from repro.models import vision_registry as j_reg
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.core import quant as t_quant
from repro_torch.core import schedule as t_sched
from repro_torch.kernels import ops
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import swin as t_swin
from repro_torch.models import vision_registry as t_reg
from repro_torch.models import vit as t_vit

MODES = ("mixed", "bf16")
ACT = {"mixed": (np.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"mixed": 1e-5, "bf16": 2e-2}

# Kernel shapes: a non-power-of-two token count and vit_edge's head width
# (Dh = 24); windowed: 4 shifted 4x4 windows of an 8x8 grid per image.
B, N, D, H, M = 2, 17, 96, 4, 384
DH = D // H
_ORDER = ("wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
          "w_up", "b_up", "w_down", "b_down")


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _layer_params(rng):
    return dict(
        wq=_f32(rng, H, D, DH, scale=D ** -0.5),
        wk=_f32(rng, H, D, DH, scale=D ** -0.5),
        wv=_f32(rng, H, D, DH, scale=D ** -0.5),
        w_msa=_f32(rng, D, D, scale=D ** -0.5),
        ln1_w=1 + _f32(rng, D, scale=0.1), ln1_b=_f32(rng, D, scale=0.1),
        ln2_w=1 + _f32(rng, D, scale=0.1), ln2_b=_f32(rng, D, scale=0.1),
        w_up=_f32(rng, D, M, scale=D ** -0.5), b_up=_f32(rng, M, scale=0.1),
        w_down=_f32(rng, M, D, scale=M ** -0.5),
        b_down=_f32(rng, D, scale=0.1))


def _j(a, dtype=jnp.bfloat16):
    """numpy float32 -> JAX array in ``dtype`` (round to nearest even)."""
    return None if a is None else jnp.asarray(a).astype(dtype)


def _t(a, dtype=torch.bfloat16):
    """The same rounding on the torch side."""
    return None if a is None else torch.from_numpy(np.array(a)).to(dtype)


def _x(a, mode):
    """An activation in the mode's dtype, for JAX and for the port."""
    return _j(a, ACT[mode][0]), _t(a, ACT[mode][1])


def _close(got: torch.Tensor, want, mode: str, tol=None) -> float:
    """got (torch) against want (JAX): same dtype, max|err| <= tol x
    max(1, output scale)."""
    assert got.dtype == ACT[mode][1]
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= (tol or TOL[mode]) * max(1.0, float(np.abs(w).max())), err
    return err


def _windows(rng):
    """Windowed-mode operands: x (B*4, 16, D), bias (H, 16, 16) and the
    shifted-window mask (4, 16, 16)."""
    x = _f32(rng, B * 4, 16, D)
    bias = _f32(rng, H, 16, 16, scale=0.5)
    mask = t_sched.shifted_window_mask(8, 8, 4, 2)
    return x, bias, mask


# ---------------------------------------------------------------------------
# Repairs: LayerNorm keeps the activation dtype; the configs take a dtype
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_layer_norm_returns_the_input_dtype(mode):
    rng = np.random.default_rng(0)
    x, w, b = _f32(rng, 5, D, scale=3.0), 1 + _f32(rng, D), _f32(rng, D)
    jx, tx = _x(x, mode)
    want = j_ops.layer_norm(jx, _j(w), _j(b))
    got = ops.layer_norm(tx, _t(w), _t(b))
    _close(got, want, mode)


def test_configs_take_dtype_and_init_casts_every_leaf():
    for cfg in (t_vit.deit_t(dtype="bfloat16"),
                t_vit.vit_b16(224, dtype="bfloat16"),
                t_swin.swin_t(dtype="bfloat16"),
                t_swin.swin_edge(dtype="bfloat16")):
        assert cfg.dtype == "bfloat16"
    assert t_vit.deit_t().dtype == t_swin.swin_t().dtype == "float32"
    for name in ("vit_edge", "deit_t_p", "swin_t", "swin_t_p"):
        cfg = t_reg.build_cfg(name)
        dense = t_reg.init_params(cfg, 3)
        bf = t_reg.init_params(dataclasses.replace(cfg, dtype="bfloat16"), 3)
        j_cfg = dataclasses.replace(j_reg.build_cfg(name), dtype="bfloat16")
        j_leaves = jax.tree_util.tree_leaves_with_path(
            j_reg.init_params(jax.random.PRNGKey(0), j_cfg))
        t_leaves = jax.tree_util.tree_leaves_with_path(bf)
        # The same tree as JAX's, every leaf bf16 (Swin's relative-position
        # tables, merge and embed LayerNorms too)...
        assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
        assert all(t.dtype == torch.bfloat16 for _, t in t_leaves)
        assert all(a.dtype == jnp.bfloat16 for _, a in j_leaves)
        # ... and the float32 draw cast to bf16 (pruned after the cast).
        for (path, t), (_, d) in zip(
                t_leaves, jax.tree_util.tree_leaves_with_path(dense)):
            if not cfg.head_mask or "w_msa" not in str(path):
                assert torch.equal(t, d.bfloat16()), path


# ---------------------------------------------------------------------------
# Kernels: the port's plain versions against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("windowed", [False, True])
def test_vita_layer_matches_pallas(mode, windowed):
    """Kernel 1: fp32 math on both sides, one rounding of the output."""
    rng = np.random.default_rng(1)
    p = _layer_params(rng)
    x, bias, mask = _windows(rng) if windowed else (_f32(rng, B, N, D),
                                                    None, None)
    jx, tx = _x(x, mode)
    want = j_vita_layer(jx, *(_j(p[k]) for k in _ORDER),
                        _j(bias, jnp.float32), _j(mask, jnp.float32),
                        interpret=True)
    got = ops.vita_layer_fused(tx, *(_t(p[k]) for k in _ORDER),
                               _t(bias, torch.float32),
                               _t(mask, torch.float32))
    _close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("windowed", [False, True])
def test_vita_msa_batched_matches_jax(mode, windowed):
    """Kernel 5 (windowed with a qkv_bias): the Pallas kernel in mixed
    mode, the fp32-accumulating oracle in bf16 (see the module note)."""
    rng = np.random.default_rng(2)
    p = _layer_params(rng)
    z, bias, mask = _windows(rng) if windowed else (_f32(rng, B, N, D),
                                                    None, None)
    qkv_bias = _f32(rng, 3, H, DH, scale=0.2) if windowed else None
    jz, tz = _x(z, mode)
    j_args = (jz, *(_j(p[k]) for k in ("wq", "wk", "wv")),
              _j(bias, jnp.float32), _j(mask, jnp.float32), _j(qkv_bias))
    want = (j_vita_msa_batched(*j_args, interpret=True) if mode == "mixed"
            else j_ref.vita_msa_batched_ref(*j_args))
    got = ops.vita_msa_batched(tz, *(_t(p[k]) for k in ("wq", "wk", "wv")),
                               _t(bias, torch.float32),
                               _t(mask, torch.float32), _t(qkv_bias))
    _close(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("biases", [True, False])
def test_fused_mlp_matches_pallas(mode, biases):
    """Kernel 6: float32 x with bf16 weights (the hidden chunk rounded to
    x's dtype: not at all), and bf16 throughout."""
    rng = np.random.default_rng(3)
    x = _f32(rng, B, N, D)
    w1, w2 = _f32(rng, D, M, scale=D ** -0.5), _f32(rng, M, D,
                                                     scale=M ** -0.5)
    b1 = _f32(rng, M, scale=0.1) if biases else None
    b2 = _f32(rng, D, scale=0.1) if biases else None
    jx, tx = _x(x, mode)
    want = j_fused_mlp(jx, _j(w1), _j(w2), _j(b1), _j(b2), interpret=True)
    got = ops.mlp(tx, _t(w1), _t(w2), _t(b1), _t(b2), activation="gelu")
    _close(got, want, mode)


def _group_operands(rng, n_l=2):
    ps = [_layer_params(rng) for _ in range(n_l)]
    return [np.stack([p[k] for p in ps]) for k in _ORDER]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("windowed", [False, True])
def test_vita_layer_group_matches_pallas(mode, windowed):
    """Kernel 7: two layers, the activation carried in fp32 between them
    on both sides."""
    rng = np.random.default_rng(4)
    stacks = _group_operands(rng)
    x, bias, mask = _windows(rng) if windowed else (_f32(rng, B, N, D),
                                                    None, None)
    if windowed:
        bias = np.stack([bias, _f32(rng, H, 16, 16, scale=0.5)])
    jx, tx = _x(x, mode)
    want = j_group(jx, *(_j(s) for s in stacks), _j(bias, jnp.float32),
                   _j(mask, jnp.float32), interpret=True)
    got = ops.vita_layer_group(tx, *(_t(s) for s in stacks),
                               _t(bias, torch.float32),
                               _t(mask, torch.float32))
    _close(got, want, mode)


def test_bf16_group_is_jax_group_not_the_chain():
    """In bf16 a group rounds once, at its end; L per-layer calls round
    after each layer.  The port's plain group follows JAX's group kernel,
    not the chain."""
    rng = np.random.default_rng(5)
    stacks = _group_operands(rng, n_l=3)
    x = _f32(rng, B, N, D)
    want = np.asarray(j_group(_j(x), *(_j(s) for s in stacks),
                              interpret=True)).astype(np.float32)
    group = ops.vita_layer_group(_t(x), *(_t(s) for s in stacks))
    chain = _t(x)
    for l in range(3):
        chain = ops.vita_layer_fused(chain, *(_t(s[l]) for s in stacks))
    assert not torch.equal(group, chain)
    off_group = int((group.float().numpy() != want).sum())
    off_chain = int((chain.float().numpy() != want).sum())
    assert off_group < off_chain / 4, (off_group, off_chain)
    _close(group, want, "bf16")


def test_unported_dtype_modes_raise():
    """Any (activation, weight) pair outside `ref.PORTED_MODES`, or
    weights of mixed dtypes, raises: nothing falls back."""
    rng = np.random.default_rng(6)
    p = _layer_params(rng)
    x = _f32(rng, B, N, D)
    stacks = _group_operands(rng)
    for act, wdt in ((torch.bfloat16, torch.float32),
                     (torch.float32, torch.float16),
                     (torch.float16, torch.float16)):
        tx = _t(x, act)
        w = {k: _t(p[k], wdt) for k in _ORDER}
        with pytest.raises(NotImplementedError, match="not a ported mode"):
            ops.vita_layer_fused(tx, *(w[k] for k in _ORDER))
        with pytest.raises(NotImplementedError, match="not a ported mode"):
            ops.vita_msa_batched(tx, w["wq"], w["wk"], w["wv"])
        with pytest.raises(NotImplementedError, match="not a ported mode"):
            ops.mlp(tx, w["w_up"], w["w_down"], w["b_up"], w["b_down"])
        with pytest.raises(NotImplementedError, match="not a ported mode"):
            ops.vita_layer_group(tx, *(_t(s, wdt) for s in stacks))
    w = {k: _t(p[k]) for k in _ORDER}
    with pytest.raises(NotImplementedError, match="not a ported mode"):
        ops.mlp(_t(x, torch.float32), w["w_up"], w["w_down"].float())


# ---------------------------------------------------------------------------
# Whole models and the server
# ---------------------------------------------------------------------------

SCHEDULES = {"fused": dict(fused=True, fuse_group=1),
             "unfused": dict(fused=False, fuse_group=1),
             "grouped": dict(fused=True, fuse_group=2)}


@functools.lru_cache(maxsize=None)
def _model(name: str):
    """JAX bf16 cfg and params (vit_edge cut to 2 layers; Swin reduced is
    swin_edge), the port's cfg and params, and 3 images."""
    cut = {"layers": 2} if name == "vit_edge" else {}
    j_cfg = dataclasses.replace(j_reg.build_cfg(name), dtype="bfloat16",
                                **cut)
    t_cfg = dataclasses.replace(t_reg.build_cfg(name), dtype="bfloat16",
                                **cut)
    params = j_reg.init_params(jax.random.PRNGKey(0), j_cfg)
    images = np.random.default_rng(7).standard_normal(
        (3, j_cfg.image, j_cfg.image, 3)).astype(np.float32)
    return j_cfg, params, t_cfg, params_from_numpy(params), images


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", ["vit_edge", "swin_t"])
def test_forward_matches_jax(name, schedule, mode):
    """The whole model, fused, unfused and grouped by 2, on float32
    patches (mixed) and bf16 patches, against JAX's `forward` with the
    same config on its Pallas kernels (the unfused bf16 MSA: the oracle)."""
    j_cfg, params, t_cfg, t_params, images = _model(name)
    backend = "xla" if (mode, schedule) == ("bf16", "unfused") else "pallas"
    j_cfg = dataclasses.replace(j_cfg, backend=backend, **SCHEDULES[schedule])
    t_cfg = dataclasses.replace(t_cfg, **SCHEDULES[schedule])
    patches = np.asarray(j_vit.extract_patches(jnp.asarray(images),
                                               j_cfg.patch))
    jp, tp = _x(patches, mode)
    want = j_reg.forward_fn(j_cfg)(params, jp, j_cfg)
    got = t_reg.forward_fn(t_cfg)(t_params, tp, t_cfg)
    _close(got, want, mode, tol=1e-4 if mode == "mixed" else None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["vit_edge", "swin_t"])
def test_forward_feeds_kernels_in_the_activation_dtype(name, mode,
                                                       monkeypatch):
    """LayerNorm restores the activation dtype before the kernels, as the
    reference's `ops.layer_norm` does: the unfused forward hands the MSA
    kernel a z, and the MLP kernel an x, in the patches' dtype, the fused
    and grouped layers too, and every phase keeps the residual stream in
    it (float32 logits in mixed mode, bf16 in bf16)."""
    _, _, t_cfg, t_params, images = _model(name)
    seen = []

    def spy(kernel, fn):
        def run(x, *args, **kw):
            seen.append((kernel, x.dtype))
            return fn(x, *args, **kw)
        monkeypatch.setattr(ops, kernel, run)

    for kernel in ("vita_msa_batched", "mlp", "vita_layer_fused",
                   "vita_layer_group"):
        spy(kernel, getattr(ops, kernel))
    patches = _t(np.asarray(t_vit.extract_patches(
        torch.from_numpy(images), t_cfg.patch)), ACT[mode][1])
    for schedule in SCHEDULES.values():
        cfg = dataclasses.replace(t_cfg, **schedule)
        logits = t_reg.forward_fn(cfg)(t_params, patches, cfg)
        assert logits.dtype == ACT[mode][1]
    assert {k for k, _ in seen} == {"vita_msa_batched", "mlp",
                                    "vita_layer_fused", "vita_layer_group"}
    assert {d for _, d in seen} == {ACT[mode][1]}


@pytest.mark.parametrize("name", ["vit_edge", "swin_t"])
def test_quantize_bf16_params_matches_jax(name):
    """PTQ of bf16 params: the same int8 codes and float32 scales as JAX's;
    LN vectors, biases and the other float leaves stay bf16."""
    _, params, _, t_params, _ = _model(name)
    want = j_reg.quantize(params)
    got = t_quant.quantize_vision_params(t_params)
    is_q = (lambda n: hasattr(n, "values") and hasattr(n, "scale"))
    w_leaves = jax.tree_util.tree_leaves_with_path(want, is_leaf=is_q)
    g_leaves = jax.tree_util.tree_leaves_with_path(
        got, is_leaf=lambda n: isinstance(n, t_quant.QTensor))
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    for (path, g), (_, w) in zip(g_leaves, w_leaves):
        if is_q(w):
            np.testing.assert_array_equal(g.values.numpy(),
                                          np.asarray(w.values), str(path))
            assert g.scale.dtype == torch.float32
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale), str(path))
        else:
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16


@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("name", ["vit_edge", "swin_t"])
def test_vision_server_from_bf16_params_matches_jax(name, mode):
    """A bf16 config brought to `VisionServer` (float32 images: mixed
    mode), float and int8 PTQ, against JAX's server on the same cfg,
    params, frozen scales and images; the port's `calibrate` of the bf16
    int8 params against JAX's scales."""
    j_cfg, params, t_cfg, t_params, images = _model(name)
    imgs = np.concatenate([images, images[:2] * 0.5])      # 5 requests
    qparams = cal = t_q = t_cal = None
    if mode == "int8":
        qparams = j_reg.quantize(params)
        cal = j_serve.calibrate(qparams, j_cfg, images, n_batches=2)
        t_q = params_from_numpy(qparams)
        mine = t_serve.calibrate(t_q, t_cfg, images, device="cpu",
                                 n_batches=2)
        assert mine.frozen.keys() == cal.frozen.keys()
        for k, v in cal.frozen.items():
            np.testing.assert_allclose(float(mine.frozen[k]), float(v),
                                       rtol=1e-5, err_msg=k)
        t_cal = calibrator_from_scales(cal.frozen)
    j_server = j_serve.VisionServer(
        j_cfg, params, serve_cfg=j_serve.ServeConfig(mode=mode,
                                                     buckets=(1, 4)),
        qparams=qparams, calibrator=cal)
    t_server = t_serve.VisionServer(
        t_cfg, t_params, serve_cfg=t_serve.ServeConfig(
            mode=mode, buckets=(1, 4), device="cpu"),
        qparams=t_q, calibrator=t_cal)
    want_reqs = j_server.submit_many(imgs)
    got_reqs = t_server.submit_many(imgs)
    j_server.run()
    t_server.run()
    want = np.stack([r.logits for r in want_reqs])
    got = np.stack([r.logits for r in got_reqs])
    assert got.dtype == np.float32 and got.shape == want.shape
    if mode == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
