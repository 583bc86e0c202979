"""The port's plain versions of the LM kernels held against the JAX Pallas
kernels (interpret mode, fp32, as the JAX package's own tests run them)
and against `repro.kernels.ref`, on the same numpy inputs:
`flash_attention`, `decode_attention`, `rglru_scan` and every mode of
`fused_mlp`; and the device dispatch of `ops` for them on the CPU.

Tolerances: float32 throughout.  The Pallas kernels block their sums
(online softmax over K tiles, a log-depth scan inside a chunk, hidden
chunks) where the plain versions sum in one pass, so results differ by
fp32 reassociation: 1e-5 of the output scale (2e-5 for the scan, whose
error grows with T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_mlp import fused_mlp as j_fused_mlp
from repro.kernels.head_attention import decode_attention as j_decode
from repro.kernels.head_attention import flash_attention as j_flash
from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan
from repro_torch.kernels import ops, ref


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("hq,hkv,causal,window,q_offset", [
    (4, 4, True, None, 0),        # MHA, causal
    (4, 2, True, None, 0),        # GQA 2:1
    (8, 1, True, 8, 0),           # MQA with a window that binds
    (4, 2, False, None, 0),       # bidirectional (encoder)
    (4, 1, True, 6, 16),          # queries after a prefix of 16 keys
])
def test_attention_ref_matches_pallas_flash(hq, hkv, causal, window,
                                            q_offset):
    rng = np.random.default_rng(hq * 7 + hkv + q_offset)
    b, dh = 2, 16
    nq, nk = 16, 16 + q_offset
    q = _f32(rng, b, hq, nq, dh)
    k, v = _f32(rng, b, hkv, nk, dh), _f32(rng, b, hkv, nk, dh)
    want = j_flash(*map(_j, (q, k, v)), causal=causal, window=window,
                   q_offset=q_offset, block_q=8, block_k=8, interpret=True)
    got = ref.attention_ref(*map(_t, (q, k, v)), causal=causal,
                            window=window, q_offset=q_offset)
    _close(got.numpy(), want)
    _close(got.numpy(), jref.attention_ref(*map(_j, (q, k, v)),
                                           causal=causal, window=window,
                                           q_offset=q_offset))
    assert torch.equal(ops.attention(*map(_t, (q, k, v)), causal=causal,
                                     window=window, q_offset=q_offset), got)


def test_attention_ref_gives_zero_for_a_row_without_keys():
    rng = np.random.default_rng(3)
    q, k, v = (_t(_f32(rng, 1, 2, 4, 8)) for _ in range(3))
    out = ref.attention_ref(q, k, v, causal=True, q_offset=-2)
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    assert bool((out[:, :, 2:].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_decode_ref_matches_pallas_decode(hq, hkv):
    rng = np.random.default_rng(hq + hkv)
    b, s, dh = 4, 32, 16
    q = _f32(rng, b, hq, dh)
    kc, vc = _f32(rng, b, hkv, s, dh), _f32(rng, b, hkv, s, dh)
    lengths = np.array([1, 7, 32, 20], np.int32)      # ragged, one full
    want = j_decode(*map(_j, (q, kc, vc, lengths)), block_k=8,
                    interpret=True)
    got = ref.decode_attention_ref(*map(_t, (q, kc, vc, lengths)))
    _close(got.numpy(), want)
    assert torch.equal(ops.decode_attention(*map(_t, (q, kc, vc, lengths))),
                       got)
    # Length 0: no valid slot gives 0 (the Pallas kernel's finite -1e30
    # sentinel would average V instead; the port follows the reference).
    zero = ref.decode_attention_ref(*map(_t, (q, kc, vc, np.zeros(
        b, np.int32))))
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("chunk", [4, 7, 32])
def test_linear_recurrence_matches_pallas_rglru_scan(chunk):
    rng = np.random.default_rng(chunk)
    b, t, w = 2, 28, 24
    a = rng.uniform(0.5, 0.999, size=(b, t, w)).astype(np.float32)
    x = _f32(rng, b, t, w)
    want = j_rglru_scan(_j(a), _j(x), chunk=chunk, interpret=True)
    got = ref.linear_recurrence_ref(_t(a), _t(x))
    _close(got.numpy(), want, rel=2e-5)
    assert torch.equal(ops.linear_recurrence(_t(a), _t(x)), got)


def test_linear_recurrence_matches_pallas_rglru_scan_at_a_ragged_t():
    """T 2,100 (the ring prompt's length, not a multiple of the port's
    32-step chunks), W 24: the plain version against the Pallas kernel's
    chunks of 210 (the largest divisor of T up to 256) and log-depth
    scan inside each."""
    rng = np.random.default_rng(2100)
    b, t, w = 1, 2100, 24
    a = rng.uniform(0.5, 0.999, size=(b, t, w)).astype(np.float32)
    x = _f32(rng, b, t, w)
    want = j_rglru_scan(_j(a), _j(x), chunk=256, interpret=True)
    got = ref.linear_recurrence_ref(_t(a), _t(x))
    _close(got.numpy(), want, rel=2e-5)


def test_rglru_ref_matches_the_sequential_oracle():
    rng = np.random.default_rng(5)
    b, t, d = 2, 13, 16
    x, gx, ga = (_f32(rng, b, t, d) for _ in range(3))
    a = _f32(rng, d)
    h0 = _f32(rng, b, d)
    want = jref.rglru_ref(*map(_j, (x, a, gx, ga, h0)))
    got = ref.rglru_ref(*map(_t, (x, a, gx, ga, h0)))
    _close(got.numpy(), want)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("activation", ["gelu", "relu", "relu2", "silu",
                                        "identity"])
def test_fused_mlp_ref_matches_pallas_every_mode(activation, gated, bias):
    rng = np.random.default_rng(len(activation) + 2 * gated + bias)
    n, d, m, d_out = 24, 32, 96, 40
    x = _f32(rng, n, d)
    w1, wg = _f32(rng, d, m, scale=d ** -0.5), _f32(rng, d, m,
                                                    scale=d ** -0.5)
    w2 = _f32(rng, m, d_out, scale=m ** -0.5)
    b1 = _f32(rng, m, scale=0.1) if bias else None
    b2 = _f32(rng, d_out, scale=0.1) if bias else None
    wg = wg if gated else None
    want = j_fused_mlp(*map(_j, (x, w1, w2, b1, b2, wg)),
                       activation=activation, block_n=8, block_h=32,
                       interpret=True)
    got = ops.mlp(*map(_t, (x, w1, w2, b1, b2, wg)), activation=activation)
    _close(got.numpy(), want)
    _close(got.numpy(), jref.fused_mlp_ref(
        *map(_j, (x, w1, b1, w2, b2)), activation=activation,
        w_gate=_j(wg)))


def test_fused_mlp_ref_rounds_the_hidden_chunk_to_the_input_dtype():
    """bf16 inputs: the hidden activation is rounded to bf16 before the
    second product (the TPU kernel's astype), and the output is bf16."""
    rng = np.random.default_rng(9)
    x = _t(_f32(rng, 8, 16)).bfloat16()
    w1 = _t(_f32(rng, 16, 32, scale=0.25)).bfloat16()
    wg = _t(_f32(rng, 16, 32, scale=0.25)).bfloat16()
    w2 = _t(_f32(rng, 32, 16, scale=0.2)).bfloat16()
    got = ref.fused_mlp_ref(x, w1, None, w2, None, activation="gelu",
                            w_gate=wg)
    assert got.dtype == torch.bfloat16
    h = ref.gelu(x.float() @ wg.float()) * (x.float() @ w1.float())
    want = (h.bfloat16().float() @ w2.float()).bfloat16()
    assert torch.equal(got, want)


def test_unknown_activation_raises():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        ops.mlp(x, torch.zeros(4, 8), torch.zeros(8, 4), activation="tanh")
