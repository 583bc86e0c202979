"""The port's plain kernel versions held against the JAX Pallas kernels
(interpret mode, fp32) on the same numpy inputs, plus the CPU dispatch of
`repro_torch.kernels.ops` and the wrappers' refusal of CPU tensors.

Tolerances: int8 products are exact in int32 on both sides, so they are
compared for equality; float results differ only by fp32 reassociation
(different matmul blocking and reduction order), hence 1e-5."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul as j_int8_matmul
from repro.kernels.vita_layer import vita_layer as j_vita_layer
from repro.kernels.vita_layer import vita_layer_int8 as j_vita_layer_int8
from repro.kernels.vita_msa import vita_msa_int8 as j_vita_msa_int8
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import fused_mlp as t_fused_mlp
from repro_torch.kernels import int8_matmul as t_int8_matmul
from repro_torch.kernels import vita_layer as t_vita_layer
from repro_torch.kernels import vita_layer_group as t_vita_layer_group
from repro_torch.kernels import vita_msa as t_vita_msa

# Non-power-of-two token count and vit_edge's head width (Dh = 24).
B, N, D, H, M = 2, 17, 96, 4, 384
DH = D // H
# TNT-S's inner stream: 16 pixel tokens of c 24, 4 heads of 6, MLP 96, on
# a batch of images x patches.
TNT_INNER = dict(b=12, n=16, d=24, h=4, m=96)


def _rng(seed):
    return np.random.default_rng(seed)


def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_params(rng, d=D, h=H, m=M):
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


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (16, 40, 24),
                                   (64, 48, 24), (64, 24, 96),
                                   (48, 384, 96)])
def test_int8_matmul_matches_pallas(m, k, n, scaled):
    rng = _rng(0)
    x, w = _i8(rng, m, k), _i8(rng, k, n)
    xs = np.float32(0.0173)
    ws = rng.uniform(1e-3, 1e-2, size=n).astype(np.float32)
    if scaled:
        want = np.asarray(j_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(xs), jnp.asarray(ws),
                                        interpret=True))
        got = ref.int8_matmul_ref(_t(x), _t(w), torch.tensor(xs), _t(ws))
    else:
        want = np.asarray(j_int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
        got = ref.int8_matmul_ref(_t(x), _t(w))
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vita_msa_int8_matches_pallas():
    rng = _rng(1)
    z = _i8(rng, B, N, D)
    ws = [_i8(rng, H, D, DH) for _ in range(3)]
    # scales that keep the scores O(1), as calibrated layers do (uniform
    # int8 codes at larger scales saturate the softmax)
    sc = [rng.uniform(2e-4, 1e-3, size=(H, DH)).astype(np.float32)
          for _ in range(3)]
    xs = np.float32(0.021)
    # identical int8 inputs give identical int32 projections
    for w in ws:
        j_acc = np.asarray(jnp.einsum("bnd,hde->bhne",
                                      jnp.asarray(z, jnp.int32),
                                      jnp.asarray(w, jnp.int32)))
        t_acc = ref.int8_matmul_ref(_t(z).unsqueeze(1), _t(w).unsqueeze(0))
        np.testing.assert_array_equal(t_acc.numpy(), j_acc)
    want = np.asarray(j_vita_msa_int8(
        jnp.asarray(z), *map(jnp.asarray, ws), jnp.asarray(xs),
        *map(jnp.asarray, sc), interpret=True))
    got = ops.vita_msa_int8(_t(z), *map(_t, ws), torch.tensor(xs),
                            *map(_t, sc))
    assert got.shape == (B, H, N, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vita_layer_matches_pallas():
    rng = _rng(2)
    x = _f32(rng, B, N, D)
    p = _layer_params(rng)
    want = np.asarray(j_vita_layer(jnp.asarray(x),
                                   *(jnp.asarray(p[k]) for k in _ORDER),
                                   interpret=True))
    got = ops.vita_layer_fused(_t(x), *(_t(p[k]) for k in _ORDER))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _int8_layer_operands(p):
    """Quantize the float layer params the way the PTQ path does, with
    fixed act scales of the magnitude calibration gives these inputs."""
    def per_head(w):
        s = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-8) / 127.0
        return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
            s.astype(np.float32)

    def per_channel(w):
        s = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127.0
        return np.clip(np.round(w / s), -127, 127).astype(np.int8), \
            s.astype(np.float32)

    heads = [per_head(p[k]) for k in ("wq", "wk", "wv")]
    mats = [per_channel(p[k]) for k in ("w_msa", "w_up", "w_down")]
    acts = np.array([3.0, 1.5, 3.0, 2.5], np.float32) / 127.0
    h, _, dh = p["wq"].shape
    return ([h_[0] for h_ in heads] + [m_[0] for m_ in mats] + [acts]
            + [h_[1].reshape(h, dh) for h_ in heads] + [m_[1] for m_ in mats]
            + [p["ln1_w"], p["ln1_b"], p["ln2_w"], p["ln2_b"], p["b_up"],
               p["b_down"]])


def test_vita_layer_int8_matches_pallas():
    rng = _rng(3)
    x = _f32(rng, B, N, D)
    p = _layer_params(rng)
    ops_ = _int8_layer_operands(p)
    acts = ops_[6]
    # The first requant site: identical int8 codes wherever the float LN
    # input agrees bit for bit; where it does not (fp32 reassociation),
    # a code may flip by one LSB at a rounding boundary and no more.
    j_ln = np.asarray(jref.layer_norm_ref(jnp.asarray(x),
                                          jnp.asarray(p["ln1_w"]),
                                          jnp.asarray(p["ln1_b"])))
    t_ln = ref.layer_norm_ref(_t(x), _t(p["ln1_w"]), _t(p["ln1_b"])).numpy()
    j_codes = np.clip(np.round(j_ln / acts[0]), -127, 127).astype(np.int8)
    t_codes = ref.quant(torch.from_numpy(t_ln), torch.tensor(acts[0])).numpy()
    same = j_ln == t_ln
    np.testing.assert_array_equal(t_codes[same], j_codes[same])
    assert np.abs(t_codes.astype(int) - j_codes.astype(int)).max() <= 1
    want = np.asarray(j_vita_layer_int8(jnp.asarray(x),
                                        *map(jnp.asarray, ops_),
                                        interpret=True))
    got = ops.vita_layer_int8(_t(x), *map(_t, ops_)).numpy()
    # Without LSB flips the outputs differ by fp32 reassociation only; a
    # flip moves an output by about one activation scale times a weight.
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=2e-2 * np.abs(want).max())
    assert np.mean(np.abs(got - want) <= 1e-4) > 0.99


@pytest.mark.parametrize("kernel", ["vita_layer", "vita_layer_int8",
                                    "vita_msa_int8", "vita_msa_batched",
                                    "fused_mlp"])
def test_kernels_at_tnt_inner_shape_match_pallas(kernel):
    """Kernels 1, 2, 3, 5 and 6 at TNT-S's inner shape (N 16, D 24, H 4,
    Dh 6, M 96), the plain versions against the Pallas kernels; kernel 4's
    inner and embed shapes are cases of `test_int8_matmul_matches_pallas`.
    Tolerances as above (1e-5; the int8 layer 2% of the output scale at
    an LSB flip, on under 1% of the outputs)."""
    from repro.kernels.fused_mlp import fused_mlp as j_fused_mlp
    from repro.kernels.vita_msa import vita_msa_batched as j_msa_batched
    b, n, d, h, m = (TNT_INNER[k] for k in "bndhm")
    dh = d // h
    rng = _rng(20)
    x = _f32(rng, b, n, d)
    p = _layer_params(rng, d, h, m)
    if kernel == "vita_layer":
        want = j_vita_layer(jnp.asarray(x),
                            *(jnp.asarray(p[k]) for k in _ORDER),
                            interpret=True)
        got = ops.vita_layer_fused(_t(x), *(_t(p[k]) for k in _ORDER))
    elif kernel == "vita_layer_int8":
        ops_ = _int8_layer_operands(p)
        want = np.asarray(j_vita_layer_int8(jnp.asarray(x),
                                            *map(jnp.asarray, ops_),
                                            interpret=True))
        got = ops.vita_layer_int8(_t(x), *map(_t, ops_)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=2e-2 * np.abs(want).max())
        assert np.mean(np.abs(got - want) <= 1e-4) > 0.99
        return
    elif kernel == "vita_msa_int8":
        z = _i8(rng, b, n, d)
        ws = [_i8(rng, h, d, dh) for _ in range(3)]
        sc = [rng.uniform(2e-3, 1e-2, size=(h, dh)).astype(np.float32)
              for _ in range(3)]
        xs = np.float32(0.021)
        want = j_vita_msa_int8(jnp.asarray(z), *map(jnp.asarray, ws),
                               jnp.asarray(xs), *map(jnp.asarray, sc),
                               interpret=True)
        got = ops.vita_msa_int8(_t(z), *map(_t, ws), torch.tensor(xs),
                                *map(_t, sc))
    elif kernel == "vita_msa_batched":
        w = [p[k] for k in ("wq", "wk", "wv")]
        want = j_msa_batched(jnp.asarray(x), *map(jnp.asarray, w),
                             interpret=True)
        got = ops.vita_msa_batched(_t(x), *map(_t, w))
        assert got.shape == (b, h, n, dh)
    else:
        w = [p[k] for k in ("w_up", "w_down", "b_up", "b_down")]
        want = j_fused_mlp(jnp.asarray(x), *map(jnp.asarray, w),
                           interpret=True)
        got = ops.mlp(*map(_t, [x] + w), activation="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    np.testing.assert_allclose(ref.gelu(_t(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launches()
    rng = _rng(4)
    ops.int8_matmul(_t(_i8(rng, 8, 16)), _t(_i8(rng, 16, 8)))
    assert set(ops.LAUNCHES.values()) == {0}


def test_cuda_wrappers_refuse_cpu_tensors():
    rng = _rng(5)
    x, w = _t(_i8(rng, 8, 16)), _t(_i8(rng, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        t_int8_matmul.int8_matmul(x, w)
    xf = _t(_f32(rng, 1, 5, D))
    p = _layer_params(rng)
    with pytest.raises(ValueError, match="CUDA"):
        t_vita_layer.vita_layer(xf, *(_t(p[k]) for k in _ORDER))
    with pytest.raises(ValueError, match="CUDA"):
        t_vita_msa.vita_msa_batched(xf, _t(p["wq"]), _t(p["wk"]),
                                    _t(p["wv"]))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_mlp.fused_mlp(xf, _t(p["w_up"]), _t(p["w_down"]))
    stacked = [_t(p[k])[None] for k in _ORDER]
    with pytest.raises(ValueError, match="CUDA"):
        t_vita_layer_group.vita_layer_group(xf, *stacked)
    q_ops = [_t(a)[None] for a in _int8_layer_operands(p)]
    with pytest.raises(ValueError, match="CUDA"):
        t_vita_layer_group.vita_layer_group_int8(xf, *q_ops)
    # the plain group is the per-layer chain, one member at a time
    torch.testing.assert_close(
        ops.vita_layer_group(xf, *stacked),
        ops.vita_layer_fused(xf, *(_t(p[k]) for k in _ORDER)), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.vita_layer_group_int8(xf, *q_ops),
        ops.vita_layer_int8(xf, *(_t(a) for a in _int8_layer_operands(p))),
        rtol=0, atol=0)
    # the windowed mode runs on the CPU too, and wants both of its terms
    ops.vita_layer_fused(xf, *(_t(p[k]) for k in _ORDER),
                         bias=torch.zeros(H, 5, 5), mask=torch.zeros(1, 5, 5))
    with pytest.raises(ValueError, match="both bias and mask"):
        ops.vita_layer_fused(xf, *(_t(p[k]) for k in _ORDER),
                             mask=torch.zeros(1, 5, 5))


def test_b_layout_reads_head_stacks_in_place():
    """Column h*Dh + e of the grouped B operand is w[h, :, e] — the merged
    QKV layout of the reference's `_merge_qkv`."""
    w = torch.arange(3 * 5 * 4, dtype=torch.float32).reshape(3, 5, 4)
    k, n, ldb, grp, grp_stride = t_int8_matmul.b_layout(w)
    flat = w.reshape(-1)
    dense = torch.stack([torch.stack([flat[(c // grp) * grp_stride + r * ldb
                                           + c % grp] for c in range(n)])
                         for r in range(k)])
    torch.testing.assert_close(dense, w.permute(1, 0, 2).reshape(5, 12))


def test_ctypes_signatures_match_sources():
    """Every C entry point is declared with as many argument types as its
    definition in csrc/ has parameters."""
    for (lib, sym), argtypes in build.SIGNATURES.items():
        src = (build.CSRC / f"{lib}.cu").read_text()
        m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", src)
        assert m, f"{sym} not defined in {lib}.cu"
        assert len(m.group(1).split(",")) == len(argtypes), sym
    assert set(build.LIBRARIES) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert {("vita_layer_group", "rt_vita_layer_group"),
            ("vita_layer_group", "rt_vita_layer_group_int8")} <= \
        set(build.SIGNATURES)
