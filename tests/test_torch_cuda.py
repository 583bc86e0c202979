"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes (N = 17 tokens, Dh = 24, M, N, K not multiples of any
tile; a 4x4 window over an 8x8 grid with a shifted mask; an MLP output
wider than one block's 256 columns).  Marked ``cuda``: each test skips where there is no card, and the
whole file runs on a machine with one by

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: int8 products are exact; float results differ by fp32
reassociation (1e-4 of the output scale); an int8 layer may flip a
requant code by one LSB at a rounding boundary (2% of the output scale).
A layer group runs the per-layer kernels' own tiles in their order, so
with float32 x it equals L calls of `vita_layer_group.tile_chain` (the
float layer on the group's mma.sync GEMM tile) bit for bit and L calls of
`vita_layer_int8` exactly; kernel 1, whose fp32-weight products take the
wgmma tile, is held to the group within 1e-6 of the output scale.  The
wgmma GEMM itself is held to a float64 product in every epilogue, bit
for bit between two calls and between an M 196 and an M 6,272 call; the int8 GEMM's
tensor-core tile (every out_kind, ragged shapes and per-head stacks at
each copy width and tile) equals its plain version bit for bit.
The LM kernels (flash and decode attention, the RG-LRU scan, the gated
and bf16 fused MLP) are held row by row, each output row to 1e-4 of its
own scale in fp32 and 2e-2 in bf16 (the kernels round P or the hidden
chunk to bf16 where the plain versions keep fp32, and round the output
once).  Decode attention's key split is also held against a one-split
launch, and the fused MLP's two regimes meet at the row count where its
plan switches.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import schedule as sched
from repro_torch.core.quant import prune_block_heads, quantize_vision_params
from repro_torch.kernels import fused_mlp as k_fused_mlp
from repro_torch.kernels import head_attention as k_head_attention
from repro_torch.kernels import int8_matmul as k_int8_matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as k_rglru_scan
from repro_torch.kernels import vita_layer as k_vita_layer
from repro_torch.kernels import vita_layer_group as k_vita_layer_group
from repro_torch.kernels import vita_msa as k_vita_msa
from repro_torch import configs, trace
from repro_torch.launch import serve as lm_serve
from repro_torch.launch import vision_serve
from repro_torch.models import transformer, tnt, vision_registry, vit

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer(card, b=2):
    cfg = vision_registry.build_cfg("vit_edge")
    bp = vit.init_params(cfg, seed=1, device=card)["layers"][0]
    x = torch.randn((b, 17, cfg.dim), device=card)
    return cfg, bp, x


def test_int8_matmul_exact(card):
    g = torch.Generator(device=card).manual_seed(0)
    for m, k, n in ((37, 53, 29), (8, 192, 1000), (130, 96, 70)):
        a = torch.randint(-127, 128, (m, k), device=card, generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), device=card, generator=g,
                          dtype=torch.int8)
        assert torch.equal(k_int8_matmul.int8_matmul(a, w),
                           ref.int8_matmul_ref(a, w))
        xs, ws = torch.tensor(0.03, device=card), torch.rand(n, device=card)
        assert torch.equal(k_int8_matmul.int8_matmul(a, w, xs, ws),
                           ref.int8_matmul_ref(a, w, xs, ws))


def test_vita_layer_float(card):
    _, bp, x = _layer(card)
    args = (x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
            bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
            bp["w_down"], bp["b_down"])
    want = ref.vita_layer_ref(*args)
    torch.testing.assert_close(k_vita_layer.vita_layer(*args), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))


def test_vita_layer_int8_and_msa_int8(card):
    cfg, bp, x = _layer(card)
    q = quantize_vision_params(bp)
    h, dh = cfg.heads, cfg.head_dim
    acts = torch.tensor([4.0, 2.0, 4.0, 3.0], device=card) / 127.0
    args = (x, q["wq"].values, q["wk"].values, q["wv"].values,
            q["w_msa"].values, q["w_up"].values, q["w_down"].values, acts,
            *[q[k].scale.reshape(h, dh) for k in ("wq", "wk", "wv")],
            *[q[k].scale.reshape(-1) for k in ("w_msa", "w_up", "w_down")],
            bp["ln1_w"], bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["b_up"],
            bp["b_down"])
    want = ref.vita_layer_int8_ref(*args)
    got = k_vita_layer.vita_layer_int8(*args)
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    zq = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    m_args = (zq, *args[1:4], torch.tensor(0.03, device=card), *args[8:11])
    want = ref.vita_msa_int8_ref(*m_args)
    torch.testing.assert_close(k_vita_msa.vita_msa_int8(*m_args), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))


def _windows(card, h, d, b=2):
    """A window-folded input (b * 4, 16, d) with its (H, 16, 16) bias and
    shifted (4, 16, 16) mask."""
    ph = sched.Phase(kind="msa", path=(), site="", grid=(8, 8), window=4,
                     shift=2)
    bp = {"rel_bias": 0.5 * torch.randn((49, h), device=card)}
    x = torch.randn((b, 64, d), device=card)
    bias, mask = sched._window_terms(ph, bp, card)
    return sched._fold(ph, x), bias, mask


def test_vita_msa_batched_all_modes(card):
    _, bp, x = _layer(card)
    w = (bp["wq"], bp["wk"], bp["wv"])
    h, _, dh = w[0].shape
    qb = 0.2 * torch.randn((3, h, dh), device=card)
    xw, bias, mask = _windows(card, h, x.shape[-1])
    for z, bi, ma, q in ((x, None, None, None), (x, None, None, qb),
                         (xw, bias, mask, None), (xw, bias, mask, qb)):
        want = ref.vita_msa_batched_ref(z, *w, bi, ma, q)
        got = k_vita_msa.vita_msa_batched(z, *w, bi, ma, q)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    torch.testing.assert_close(k_vita_msa.vita_msa(x[0], *w),
                               ref.vita_msa_ref(x[0], *w), rtol=0, atol=1e-5)


def test_fused_mlp_ragged_and_wide(card):
    for rows, d, m, d_out in ((37, 96, 384, 96), (2 * 17, 40, 72, 300)):
        x = torch.randn((rows, d), device=card)
        w1 = torch.randn((d, m), device=card) * d ** -0.5
        w2 = torch.randn((m, d_out), device=card) * m ** -0.5
        b1, b2 = torch.randn(m, device=card), torch.randn(d_out, device=card)
        for bb in ((b1, b2), (None, None)):
            want = ref.fused_mlp_ref(x, w1, bb[0], w2, bb[1])
            got = k_fused_mlp.fused_mlp(x, w1, w2, *bb)
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))
    want = ref.fused_mlp_ref(x, w1, None, w2, None, activation="silu")
    torch.testing.assert_close(
        k_fused_mlp.fused_mlp(x, w1, w2, activation="silu"), want, rtol=0,
        atol=1e-4 * float(want.abs().max()))


def test_windowed_layers_and_int8_msa(card):
    cfg, bp, x = _layer(card)
    h, dh = cfg.heads, cfg.head_dim
    xw, bias, mask = _windows(card, h, cfg.dim)
    f_args = (xw, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
              bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
              bp["w_down"], bp["b_down"], bias, mask)
    want = ref.vita_layer_ref(*f_args)
    torch.testing.assert_close(k_vita_layer.vita_layer(*f_args), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))
    q = quantize_vision_params(bp)
    acts = torch.tensor([4.0, 2.0, 4.0, 3.0], device=card) / 127.0
    i_args = (xw, q["wq"].values, q["wk"].values, q["wv"].values,
              q["w_msa"].values, q["w_up"].values, q["w_down"].values, acts,
              *[q[k].scale.reshape(h, dh) for k in ("wq", "wk", "wv")],
              *[q[k].scale.reshape(-1) for k in ("w_msa", "w_up", "w_down")],
              bp["ln1_w"], bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["b_up"],
              bp["b_down"], bias, mask)
    want = ref.vita_layer_int8_ref(*i_args)
    got = k_vita_layer.vita_layer_int8(*i_args)
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    zq = torch.clamp(torch.round(xw / 0.03), -127, 127).to(torch.int8)
    qb = 0.2 * torch.randn((3, h, dh), device=card)
    m_args = (zq, *i_args[1:4], torch.tensor(0.03, device=card),
              *i_args[8:11], bias, mask, qb)
    want = ref.vita_msa_int8_ref(*m_args)
    torch.testing.assert_close(k_vita_msa.vita_msa_int8(*m_args), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))


def test_ops_counts_launches_and_raises_on_bad_input(card):
    ops.reset_launches()
    a = torch.zeros((4, 8), dtype=torch.int8, device=card)
    ops.int8_matmul(a, torch.zeros((8, 4), dtype=torch.int8, device=card))
    assert ops.LAUNCHES["int8_matmul"] == 1
    with pytest.raises(TypeError):
        k_int8_matmul.int8_matmul(a.float(), torch.zeros((8, 4), device=card))
    with pytest.raises(ValueError):
        k_int8_matmul.int8_matmul(a.t(), torch.zeros(
            (4, 4), dtype=torch.int8, device=card))


@pytest.mark.parametrize("name,mode,fused", [
    ("vit_edge", "float", True), ("vit_edge", "int8", True),
    ("vit_edge", "float", False), ("swin_t", "float", True),
    ("swin_t", "int8", True), ("swin_t", "float", False)])
def test_server_on_the_card_matches_the_cpu(card, name, mode, fused):
    sc = vision_serve.ServeConfig(mode=mode, buckets=(1, 4), calib_images=4,
                                  fused=fused)
    server = vision_serve.make_server(name, sc)
    side = server.cfg.image
    images = np.random.default_rng(0).standard_normal(
        (5, side, side, 3)).astype(np.float32)
    twin = vision_serve.make_server(
        name, vision_serve.ServeConfig(mode=mode, buckets=(1, 4),
                                       fused=fused, device="cpu"),
        params=vit.to_device(server.params, "cpu"),
        qparams=None if server.qparams is None
        else vit.to_device(server.qparams, "cpu"),
        calibrator=server.calibrator)
    got = server.submit_many(images)
    want = twin.submit_many(images)
    server.run()
    twin.run()
    g = np.stack([r.logits for r in got])
    w = np.stack([r.logits for r in want])
    tol = (1e-3 if mode == "float" else 2e-2) * np.abs(w).max()
    assert np.abs(g - w).max() <= tol


_ORDER = ("wq", "wk", "wv", "w_msa", "ln1_w", "ln1_b", "ln2_w", "ln2_b",
          "w_up", "b_up", "w_down", "b_down")


@pytest.mark.parametrize("kind", ["global", "windowed", "pruned",
                                  "one_head"])
def test_layer_group_kernels_match_plain_and_chain(card, kind):
    """Kernels 7 and 8 at three layers: against their plain versions and
    against three calls of the per-layer kernel (1 and 2).  ``pruned`` keeps 2 of 4
    heads (H*Dh = 48 < D = 96), ``one_head`` 1 of 4, ``windowed`` folds
    four shifted 4x4 windows."""
    cfg = vision_registry.build_cfg("vit_edge")
    params = vit.init_params(dataclasses.replace(cfg, layers=3), seed=2,
                             device=card)
    keep = {"pruned": [0, 2], "one_head": [1]}.get(
        kind, list(range(cfg.heads)))
    blocks = [prune_block_heads(bp, [int(i in keep) for i in
                                     range(cfg.heads)])
              for bp in params["layers"]]
    h, dh = len(keep), cfg.head_dim
    x = torch.randn((2, 17, cfg.dim), device=card)
    bias = mask = None
    if kind == "windowed":
        x, _, mask = _windows(card, h, cfg.dim)
        bias = 0.5 * torch.randn((3, h, 16, 16), device=card)
    sp = {k: torch.stack([bp[k] for bp in blocks]) for k in _ORDER}
    f_args = [x] + [sp[k] for k in _ORDER]
    got = k_vita_layer_group.vita_layer_group(*f_args, bias, mask)
    want = ref.vita_layer_group_ref(*f_args, bias, mask)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
    y = x
    for l, bp in enumerate(blocks):
        y = k_vita_layer.vita_layer(y, *[bp[k] for k in _ORDER],
                                    None if bias is None else bias[l], mask)
    assert float((got - y).abs().max()) <= 1e-6 * scale
    qs = [quantize_vision_params(bp) for bp in blocks]
    acts = torch.tensor([[4.0, 2.0, 4.0, 3.0]] * 3, device=card) / 127.0
    i_args = [x] + [torch.stack([q[k].values for q in qs]) for k in
                    ("wq", "wk", "wv", "w_msa", "w_up", "w_down")] + [acts] \
        + [torch.stack([q[k].scale.reshape(h, dh) for q in qs])
           for k in ("wq", "wk", "wv")] \
        + [torch.stack([q[k].scale.reshape(-1) for q in qs])
           for k in ("w_msa", "w_up", "w_down")] \
        + [sp[k] for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up",
                           "b_down")]
    got = k_vita_layer_group.vita_layer_group_int8(*i_args, bias, mask)
    want = ref.vita_layer_group_int8_ref(*i_args, bias, mask)
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    y = x
    for l in range(3):
        y = k_vita_layer.vita_layer_int8(
            y, *[a[l] for a in i_args[1:]],
            None if bias is None else bias[l], mask)
    assert torch.equal(got, y)


@pytest.mark.parametrize("name,mode,group", [
    ("vit_edge", "float", 4), ("vit_edge", "int8", 4), ("swin_t", "float", 4),
    ("swin_t", "int8", 4), ("deit_t_p", "float", 4), ("deit_t_p", "int8", 4),
    ("swin_t_p", "float", 1)])
def test_grouped_and_pruned_servers_on_the_card_match_the_cpu(card, name,
                                                              mode, group):
    sc = vision_serve.ServeConfig(mode=mode, buckets=(1, 4), calib_images=4,
                                  fuse_group=group)
    server = vision_serve.make_server(name, sc)
    twin = vision_serve.make_server(
        name, dataclasses.replace(sc, device="cpu"),
        params=vit.to_device(server.params, "cpu"),
        qparams=None if server.qparams is None
        else vit.to_device(server.qparams, "cpu"),
        calibrator=server.calibrator)
    side = server.cfg.image
    images = np.random.default_rng(0).standard_normal(
        (5, side, side, 3)).astype(np.float32)
    got = server.submit_many(images)
    want = twin.submit_many(images)
    ops.reset_launches()
    stats = server.run()
    twin.run()
    kernel = "vita_layer_group" + ("_int8" if mode == "int8" else "")
    grouped = "layer_group" in vision_registry.make_schedule(
        server.cfg).counts()
    assert (ops.LAUNCHES[kernel] > 0) == grouped
    assert stats["group_buckets"] == {"1": group, "4": group}
    g = np.stack([r.logits for r in got])
    w = np.stack([r.logits for r in want])
    tol = (1e-3 if mode == "float" else 2e-2) * np.abs(w).max()
    assert np.abs(g - w).max() <= tol


# The bf16 vision modes of kernels 1, 5, 6 and 7 (`ref.PORTED_MODES`):
# "mixed" is float32 activations with bf16 weights (fp32 math on exactly
# upcast weights: the fp32 limit), "bf16" bf16 throughout (kernels and
# plain versions round at the same points, P and V or the hidden chunk
# and the output, but fp32 reassociation can move a value across a
# rounding boundary: 1e-2 of each output row's own scale, a few bf16
# ulps).
_BF16_MODES = {"mixed": torch.float32, "bf16": torch.bfloat16}
_BF16_TOL = {"mixed": 1e-5, "bf16": 1e-2}


def _held(got, want, mode):
    """max|err| per output row (last axis) over max(that row's scale,
    1e-2 x the largest) within the mode's limit; dtypes and shapes
    equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs().reshape(-1, got.shape[-1])
    rows = want.float().abs().reshape(-1, got.shape[-1]).amax(1)
    ratio = diff.amax(1) / torch.clamp(rows, min=1e-2 * float(rows.max()))
    assert float(ratio.max()) <= _BF16_TOL[mode], float(ratio.max())


def _bf16_blocks(card, layers=1, seed=2):
    """vit_edge blocks with bf16 weights and non-zero LN vectors and
    biases."""
    cfg = dataclasses.replace(vision_registry.build_cfg("vit_edge"),
                              layers=layers, dtype="bfloat16")
    g = torch.Generator(device=card).manual_seed(seed)
    blocks = []
    for bp in vit.init_params(cfg, seed=seed, device=card)["layers"]:
        bp = dict(bp)
        for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up", "b_down"):
            bp[k] = (bp[k].float() + 0.1 * torch.randn(
                bp[k].shape, generator=g, device=card)).bfloat16()
        blocks.append(bp)
    return cfg, blocks


@pytest.mark.parametrize("mode", sorted(_BF16_MODES))
@pytest.mark.parametrize("windowed", [False, True])
def test_vita_layer_and_msa_bf16_modes(card, mode, windowed):
    """Kernels 1 and 5 with bf16 weights on float32 (mixed) or bf16
    activations, global and windowed, against their plain versions."""
    cfg, (bp,) = _bf16_blocks(card)
    h, dh = cfg.heads, cfg.head_dim
    x = torch.randn((2, 17, cfg.dim), device=card)
    bias = mask = None
    if windowed:
        x, bias, mask = _windows(card, h, cfg.dim)
    x = x.to(_BF16_MODES[mode])
    f_args = (x, *[bp[k] for k in _ORDER], bias, mask)
    _held(k_vita_layer.vita_layer(*f_args), ref.vita_layer_ref(*f_args), mode)
    w = (bp["wq"], bp["wk"], bp["wv"])
    qb = (0.2 * torch.randn((3, h, dh), device=card)).bfloat16()
    for q in (None, qb):
        _held(k_vita_msa.vita_msa_batched(x, *w, bias, mask, q),
              ref.vita_msa_batched_ref(x, *w, bias, mask, q), mode)


@pytest.mark.parametrize("mode", sorted(_BF16_MODES))
def test_fused_mlp_bf16_weights(card, mode):
    """Kernel 6 with bf16 weights and biases on float32 (mixed) or bf16
    x, ragged and wider than one block's 256 columns."""
    dt = _BF16_MODES[mode]
    for rows, d, m, d_out in ((37, 96, 384, 96), (2 * 17, 40, 72, 300)):
        x = torch.randn((rows, d), device=card).to(dt)
        w1 = (torch.randn((d, m), device=card) * d ** -0.5).bfloat16()
        w2 = (torch.randn((m, d_out), device=card) * m ** -0.5).bfloat16()
        b1 = torch.randn(m, device=card).bfloat16()
        b2 = torch.randn(d_out, device=card).bfloat16()
        for bb in ((b1, b2), (None, None)):
            _held(k_fused_mlp.fused_mlp(x, w1, w2, *bb),
                  ref.fused_mlp_ref(x, w1, bb[0], w2, bb[1]), mode)


@pytest.mark.parametrize("mode", sorted(_BF16_MODES))
@pytest.mark.parametrize("windowed", [False, True])
def test_layer_group_bf16_modes(card, mode, windowed):
    """Kernel 7 with bf16 stacks against its plain version (fp32 carry,
    one rounding at the end); in mixed mode also equal to three calls of
    `vita_layer`, as in fp32."""
    cfg, blocks = _bf16_blocks(card, layers=3)
    x = torch.randn((2, 17, cfg.dim), device=card)
    bias = mask = None
    if windowed:
        x, _, mask = _windows(card, cfg.heads, cfg.dim)
        bias = 0.5 * torch.randn((3, cfg.heads, 16, 16), device=card)
    x = x.to(_BF16_MODES[mode])
    sp = [torch.stack([bp[k] for bp in blocks]) for k in _ORDER]
    got = k_vita_layer_group.vita_layer_group(x, *sp, bias, mask)
    _held(got, ref.vita_layer_group_ref(x, *sp, bias, mask), mode)
    if mode == "mixed":
        y = x
        for l, bp in enumerate(blocks):
            y = k_vita_layer.vita_layer(
                y, *[bp[k] for k in _ORDER],
                None if bias is None else bias[l], mask)
        assert float((got - y).abs().max()) <= 1e-6 * float(y.abs().max())


def test_int8_kernels_read_bf16_vectors(card):
    """Kernels 2, 3 and 8 with a bf16 model's LN vectors and biases give
    exactly what they give with the same vectors upcast to float32 (the
    TPU kernels' in-kernel astype)."""
    cfg, blocks = _bf16_blocks(card, layers=2)
    h, dh = cfg.heads, cfg.head_dim
    qs = [quantize_vision_params(bp) for bp in blocks]
    x = torch.randn((2, 17, cfg.dim), device=card)
    acts = torch.tensor([[4.0, 2.0, 4.0, 3.0]] * 2, device=card) / 127.0
    vec_keys = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up", "b_down")

    def group_args(vdtype):
        return [x] + [torch.stack([q[k].values for q in qs]) for k in
                      ("wq", "wk", "wv", "w_msa", "w_up", "w_down")] \
            + [acts] + [torch.stack([q[k].scale.reshape(h, dh) for q in qs])
                        for k in ("wq", "wk", "wv")] \
            + [torch.stack([q[k].scale.reshape(-1) for q in qs])
               for k in ("w_msa", "w_up", "w_down")] \
            + [torch.stack([bp[k] for bp in blocks]).to(vdtype)
               for k in vec_keys]

    bf, f32 = group_args(torch.bfloat16), group_args(torch.float32)
    assert torch.equal(k_vita_layer_group.vita_layer_group_int8(*bf),
                       k_vita_layer_group.vita_layer_group_int8(*f32))
    layer_bf = [a[0] for a in bf[1:]]
    layer_f32 = [a[0] for a in f32[1:]]
    assert torch.equal(k_vita_layer.vita_layer_int8(x, *layer_bf),
                       k_vita_layer.vita_layer_int8(x, *layer_f32))
    zq = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    qb = (0.2 * torch.randn((3, h, dh), device=card)).bfloat16()
    m_args = (zq, *layer_bf[:3], torch.tensor(0.03, device=card),
              *layer_bf[7:10])
    assert torch.equal(k_vita_msa.vita_msa_int8(*m_args, qkv_bias=qb),
                       k_vita_msa.vita_msa_int8(*m_args, qkv_bias=qb.float()))


@pytest.mark.parametrize("name,mode,fused,group", [
    ("vit_edge", "float", True, 1), ("vit_edge", "int8", True, 1),
    ("vit_edge", "float", False, 1), ("vit_edge", "float", True, 2),
    ("swin_t", "float", True, 2), ("swin_t", "int8", False, 1)])
def test_bf16_model_served_on_the_card_matches_the_cpu(card, name, mode,
                                                       fused, group):
    """A bf16 model brought to `VisionServer` (float32 images: mixed
    mode) on the card against the same server on the CPU."""
    cfg = dataclasses.replace(vision_registry.build_cfg(name),
                              dtype="bfloat16", fused=fused, fuse_group=group)
    params = vision_registry.init_params(cfg, 0, "cpu")
    side = cfg.image
    images = np.random.default_rng(0).standard_normal(
        (5, side, side, 3)).astype(np.float32)
    qparams = cal = None
    if mode == "int8":
        qparams = vision_registry.quantize(params)
        cal = vision_serve.calibrate(qparams, cfg, images[:4],
                                     device="cpu", n_batches=2)
    logits = []
    for device in (card, "cpu"):
        server = vision_serve.VisionServer(
            cfg, params, serve_cfg=vision_serve.ServeConfig(
                mode=mode, buckets=(1, 4), device=str(device)),
            qparams=qparams, calibrator=cal)
        reqs = server.submit_many(images)
        ops.reset_launches()
        server.run()
        if device == card:
            # every launch with a dtype mode ran the bf16-weight one
            assert sum(ops.LAUNCHES.values()) > 0
            assert all(k[2] == "bfloat16" for k in ops.MODE_LAUNCHES)
            assert (sum(ops.MODE_LAUNCHES.values()) > 0) == (
                fused or mode == "float")
        logits.append(np.stack([r.logits for r in reqs]))
    g, w = logits
    tol = (1e-3 if mode == "float" else 2e-2) * np.abs(w).max()
    assert np.abs(g - w).max() <= tol


_LM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _lm_close(got, want):
    """Row by row (the last axis): each row's max|err| within the dtype's
    tolerance times that row's own max|want| (at least 1e-2 of the
    largest), so rows of small outputs are held at their own scale."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs().reshape(-1, got.shape[-1])
    scale = want.float().abs().reshape(-1, got.shape[-1]).amax(1)
    floor = 1e-2 * float(scale.max()) or 1e-30
    assert bool((diff.amax(1) <= _LM_TOL[want.dtype]
                 * torch.clamp(scale, min=floor)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,dh,nq,nk,window,q_offset", [
    (10, 1, 256, 13, 13, None, 0), (4, 4, 80, 37, 37, None, 0),
    (4, 2, 64, 150, 150, 40, 0), (4, 1, 32, 5, 70, 16, 65),
    (2, 1, 16, 3, 9, None, -4),
    # many key tiles and the window's edge inside them, at Dh 256 / GQA 10:1
    (10, 1, 256, 300, 300, 100, 0),
    # ragged: Dh 80 over 77 queries (two 64-row tiles, the second of 13)
    (4, 2, 80, 77, 77, 30, 0),
    # Dh 20: padded to 32; bf16 rows are 40 bytes, staged by plain loads
    (3, 1, 20, 40, 50, 17, 5)])
def test_flash_attention_matches_plain(card, dtype, hq, hkv, dh, nq, nk,
                                       window, q_offset):
    g = torch.Generator(device=card).manual_seed(hq + dh)
    q = torch.randn((2, hq, nq, dh), generator=g, device=card).to(dtype)
    k = torch.randn((2, hkv, nk, dh), generator=g, device=card).to(dtype)
    v = torch.randn((2, hkv, nk, dh), generator=g, device=card).to(dtype)
    for causal in (True, False):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        _lm_close(k_head_attention.flash_attention(q, k, v, **kw),
                  ref.attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_tensors_take_plain_loads(card, dtype):
    """q, k and v one element past a 16-byte boundary (contiguous views):
    the plan stages them by plain loads into the same layout."""
    def view(shape, g):
        n = int(np.prod(shape))
        flat = torch.randn(n + 1, generator=g, device=card).to(dtype)
        return flat[1:].view(shape)

    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (view((1, 4, 70, 64), g), view((1, 2, 70, 64), g),
               view((1, 2, 70, 64), g))
    assert k_head_attention.plan_for(q, k, v).vec == 0
    _lm_close(k_head_attention.flash_attention(q, k, v, window=20),
              ref.attention_ref(q, k, v, window=20))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,dh,s", [(10, 1, 256, 128), (8, 8, 80, 77),
                                         (4, 2, 64, 300)])
def test_decode_attention_matches_plain(card, dtype, hq, hkv, dh, s):
    g = torch.Generator(device=card).manual_seed(s)
    q = torch.randn((4, hq, dh), generator=g, device=card).to(dtype)
    kc = torch.randn((4, hkv, s, dh), generator=g, device=card).to(dtype)
    vc = torch.randn((4, hkv, s, dh), generator=g, device=card).to(dtype)
    lengths = torch.tensor([1, s // 2 + 3, s, 0], dtype=torch.int32,
                           device=card)
    got = k_head_attention.decode_attention(q, kc, vc, lengths)
    _lm_close(got, ref.decode_attention_ref(q, kc, vc, lengths))
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_matches_plain(card, dtype):
    """The walk (T up to one chunk: 32 steps in fp32, 64 in bf16) and the
    chunked scan with its look-back: T around either chunk and past 32
    chunks (a look-back window), ragged T (2,100) and W (100), one and
    three sequences."""
    g = torch.Generator(device=card).manual_seed(4)
    for t in (1, 13, 32, 33, 63, 64, 65, 257, 2100, 4096):
        for b in (1, 3):
            for w in (100, 2560):
                a = (0.5 + 0.499 * torch.rand((b, t, w), generator=g,
                                              device=card)).to(dtype)
                x = torch.randn((b, t, w), generator=g,
                                device=card).to(dtype)
                _lm_close(k_rglru_scan.rglru_scan(a, x),
                          ref.linear_recurrence_ref(a, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_replays_in_a_cuda_graph(card, dtype):
    """The chunked scan leaves its flags clear for the next launch, so a
    captured launch replays right, on inputs changed between replays."""
    g = torch.Generator(device=card).manual_seed(5)
    shape = (2, 2100, 300)
    a = (0.5 + 0.499 * torch.rand(shape, generator=g, device=card)).to(dtype)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    k_rglru_scan.rglru_scan(a, x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h = k_rglru_scan.rglru_scan(a, x)
    for _ in range(3):
        a.copy_((0.5 + 0.499 * torch.rand(shape, generator=g,
                                          device=card)).to(dtype))
        x.copy_(torch.randn(shape, generator=g, device=card).to(dtype))
        graph.replay()
        _lm_close(h, ref.linear_recurrence_ref(a, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", sorted(ref.ACTIVATIONS))
def test_fused_mlp_every_mode_matches_plain(card, dtype, activation):
    """Gated and not, with and without biases, at a decode shape (4 rows:
    hidden split) and a ragged prefill shape, D_out 300 (two slices)."""
    g = torch.Generator(device=card).manual_seed(len(activation))
    d, m, d_out = 96, 200, 300
    w1 = (torch.randn((d, m), generator=g, device=card) * d ** -0.5)
    wg = (torch.randn((d, m), generator=g, device=card) * d ** -0.5)
    w2 = (torch.randn((m, d_out), generator=g, device=card) * m ** -0.5)
    b1 = 0.1 * torch.randn(m, generator=g, device=card)
    b2 = 0.1 * torch.randn(d_out, generator=g, device=card)
    w1, wg, w2, b1, b2 = (t.to(dtype) for t in (w1, wg, w2, b1, b2))
    for rows in (4, 37):
        x = torch.randn((rows, d), generator=g, device=card).to(dtype)
        for gate in (None, wg):
            for bb in ((b1, b2), (None, None)):
                want = ref.fused_mlp_ref(x, w1, bb[0], w2, bb[1],
                                         activation=activation, w_gate=gate)
                got = k_fused_mlp.fused_mlp(x, w1, w2, *bb, gate,
                                            activation=activation)
                _lm_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 40])
def test_fused_mlp_hidden_split_matches_one_pass(card, dtype, rows,
                                                 monkeypatch):
    """A decode step's 4 rows (the few-rows regime: a block per SM over
    the hidden chunks) and 40 rows (one row tile in two output slices: the
    many-rows regime splits the hidden dimension to fill the card) both
    give more than one hidden split; asked for one, the plan takes one
    (8 chunks fit one block), and all three match."""
    g = torch.Generator(device=card).manual_seed(3)
    d, m, d_out = 256, 500, 300
    x = torch.randn((rows, d), generator=g, device=card).to(dtype)
    w1, wg = (torch.randn((d, m), generator=g, device=card).to(dtype)
              * d ** -0.5 for _ in range(2))
    w2 = (torch.randn((m, d_out), generator=g, device=card)
          * m ** -0.5).to(dtype)
    code = 1 if dtype == torch.bfloat16 else 0
    assert k_fused_mlp.hidden_splits(rows, d, m, d_out, code) > 1
    split = k_fused_mlp.fused_mlp(x, w1, w2, w_gate=wg)
    planned = k_fused_mlp.hidden_splits
    monkeypatch.setattr(k_fused_mlp, "hidden_splits",
                        lambda *a: planned(*a, requested=1))
    assert k_fused_mlp.hidden_splits(rows, d, m, d_out, code) == 1
    one_pass = k_fused_mlp.fused_mlp(x, w1, w2, w_gate=wg)
    want = ref.fused_mlp_ref(x, w1, None, w2, None, w_gate=wg)
    _lm_close(split, want)
    _lm_close(one_pass, want)
    _lm_close(split, one_pass)


@pytest.mark.parametrize("mode", ["fp32", "mixed", "bf16"])
@pytest.mark.parametrize("activation", sorted(ref.ACTIVATIONS))
def test_fused_mlp_regimes_meet_at_the_switch(card, mode, activation):
    """The last row count of the few-rows regime and the first of the
    many-rows one, in every dtype mode and activation, gated and not, with
    and without biases, at a ragged shape (D_out 300: a bf16 W2 row of 600
    bytes is no whole number of 16-byte copies)."""
    xdt = torch.bfloat16 if mode == "bf16" else torch.float32
    wdt = torch.float32 if mode == "fp32" else torch.bfloat16
    g = torch.Generator(device=card).manual_seed(len(activation) + len(mode))
    d, m, d_out = 136, 328, 300
    w1, wg = ((torch.randn((d, m), generator=g, device=card)
               * d ** -0.5).to(wdt) for _ in range(2))
    w2 = (torch.randn((m, d_out), generator=g, device=card)
          * m ** -0.5).to(wdt)
    b1 = (0.1 * torch.randn(m, generator=g, device=card)).to(wdt)
    b2 = (0.1 * torch.randn(d_out, generator=g, device=card)).to(wdt)
    few = k_fused_mlp.FEW_ROWS
    assert (k_fused_mlp._library(few), k_fused_mlp._library(few + 1)) == \
        ("fused_mlp", "fused_mlp_rows")
    for rows in (few, few + 1):
        x = torch.randn((rows, d), generator=g, device=card).to(xdt)
        for gate in (None, wg):
            for bb in ((b1, b2), (None, None)):
                want = ref.fused_mlp_ref(x, w1, bb[0], w2, bb[1],
                                         activation=activation, w_gate=gate)
                got = k_fused_mlp.fused_mlp(x, w1, w2, *bb, gate,
                                            activation=activation)
                if mode == "mixed":
                    _held(got, want, mode)
                else:
                    _lm_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,dh,s", [(10, 1, 256, 2048), (16, 16, 80, 128),
                                         (4, 2, 64, 300), (4, 2, 20, 100)])
def test_decode_attention_splits_match_one_split(card, dtype, hq, hkv, dh,
                                                 s, monkeypatch):
    """The key split (flash-decoding) against a one-split launch and the
    plain version: lengths 0, 1 and S, one that ends inside a 32-key tile
    and one inside a split; Dh 80 (stablelm-3b, one query row per block)
    and Dh 20 (bf16 rows of 40 bytes: staged without 16-byte copies)."""
    g = torch.Generator(device=card).manual_seed(s + dh)
    b = 6
    q = torch.randn((b, hq, dh), generator=g, device=card).to(dtype)
    kc = torch.randn((b, hkv, s, dh), generator=g, device=card).to(dtype)
    vc = torch.randn((b, hkv, s, dh), generator=g, device=card).to(dtype)
    splits = k_head_attention.decode_splits(b, hkv, s)
    assert splits > 1
    tiles = -(-s // 32)
    per = -(-tiles // splits) * 32          # keys of one split
    lengths = torch.tensor([0, 1, s, 45, min(s - 1, per + 17), s - 3],
                           dtype=torch.int32, device=card)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    got = k_head_attention.decode_attention(q, kc, vc, lengths)
    monkeypatch.setattr(k_head_attention, "decode_splits", lambda *a: 1)
    one = k_head_attention.decode_attention(q, kc, vc, lengths)
    _lm_close(got, want)
    _lm_close(one, want)
    _lm_close(got, one)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(one[0], torch.zeros_like(one[0]))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "stablelm-3b"])
def test_lm_server_on_the_card_matches_the_cpu(card, arch):
    """Reduced widths, fp32: the card's greedy tokens and logits against
    the same weights served on the CPU, and every LM kernel launched."""
    cfg = configs.get(arch).reduced()
    params = transformer.init_params(cfg, seed=0, device=card)
    twin = vit.to_device(params, "cpu")
    out = {}
    ops.reset_launches()
    for where, p in (("cuda", params), ("cpu", twin)):
        server = lm_serve.SlotServer(cfg, p, 2, 32, keep_logits=True)
        done = lm_serve.drain(server, lm_serve.make_requests(cfg, 3, 12, 5,
                                                             seed=2))
        out[where] = sorted(done, key=lambda r: r.rid)
    assert ops.LAUNCHES["flash_attention"] > 0
    assert ops.LAUNCHES["decode_attention"] > 0
    assert ops.LAUNCHES["fused_mlp"] > 0
    assert (ops.LAUNCHES["rglru_scan"] > 0) == (arch == "recurrentgemma-2b")
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.generated == b.generated
        ga, gb = np.stack(a.logits), np.stack(b.logits)
        assert np.abs(ga - gb).max() <= 1e-3 * np.abs(gb).max()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b",
                                  "xlstm-1.3b"])
def test_moe_and_xlstm_servers_on_the_card_match_the_cpu(card, arch):
    """Reduced widths, fp32: the MoE configs and xLSTM served on the card
    against the same weights on the CPU (the same greedy tokens, logits
    within 1e-3 of the scale); an MoE launches the attention kernels and
    no fused MLP (its experts are batched products), xLSTM none of the
    port's kernels."""
    cfg = configs.get(arch).reduced()
    params = transformer.init_params(cfg, seed=0, device=card)
    twin = vit.to_device(params, "cpu")
    out = {}
    ops.reset_launches()
    for where, p in (("cuda", params), ("cpu", twin)):
        server = lm_serve.SlotServer(cfg, p, 2, 32, keep_logits=True)
        done = lm_serve.drain(server, lm_serve.make_requests(cfg, 3, 12, 5,
                                                             seed=2))
        out[where] = sorted(done, key=lambda r: r.rid)
    moe = cfg.moe is not None
    assert (ops.LAUNCHES["flash_attention"] > 0) == moe
    assert (ops.LAUNCHES["decode_attention"] > 0) == moe
    assert ops.LAUNCHES["fused_mlp"] == ops.LAUNCHES["rglru_scan"] == 0
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.generated == b.generated
        ga, gb = np.stack(a.logits), np.stack(b.logits)
        assert np.abs(ga - gb).max() <= 1e-3 * np.abs(gb).max()


def test_embeds_and_image_modes_on_the_card_match_the_cpu(card):
    """Reduced widths, fp32: HuBERT's `forward` on frames (non-causal
    flash and the fused MLP) and InternVL2's prefill with patch
    embeddings then decode steps through `steps`, against the CPU."""
    from repro_torch.launch import steps

    rng = np.random.default_rng(3)
    cfg = configs.get("hubert-xlarge").reduced()
    params = transformer.init_params(cfg, seed=0, device=card)
    emb = torch.from_numpy(rng.standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    ops.reset_launches()
    got = steps.make_forward_step(cfg)(params, {"embeds": emb.to(card)})
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    want = transformer.forward(vit.to_device(params, "cpu"),
                               {"embeds": emb}, cfg)
    assert (got.cpu() - want).abs().max() <= 1e-3 * want.abs().max()

    cfg = configs.get("internvl2-26b").reduced()
    params = transformer.init_params(cfg, seed=0, device=card)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5))),
             "patch_embeds": torch.from_numpy(rng.standard_normal(
                 (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))}
    logits = {}
    for where, p in (("cuda", params), ("cpu", vit.to_device(params, "cpu"))):
        b = {k: v.to(where) for k, v in batch.items()}
        tok, caches, lg = steps.make_prefill_step(cfg, 24, with_logits=True)(
            p, b)
        rows = [lg]
        pos = torch.full((2,), steps.next_position(cfg, b), device=where)
        decode = steps.make_decode_step(cfg, with_logits=True)
        for i in range(3):
            tok, caches, lg = decode(p, tok, caches, pos + i)
            rows.append(lg)
        logits[where] = torch.stack(rows, 1).cpu()
    assert (logits["cuda"] - logits["cpu"]).abs().max() \
        <= 1e-3 * logits["cpu"].abs().max()


# Kernels 5 and 1 on the tensor cores: the MSA tile (one thread-block
# cluster per (image, head), K and V shared through distributed shared
# memory) and the layer's split-TF32 GEMM tile, in every dtype mode, at
# the bounds of the checks above: float32 1e-4 of the output scale, mixed
# 1e-5 and bf16 1e-2 of each row's scale (`_held`).
_MODES3 = {"fp32": (torch.float32, torch.float32),
           "mixed": (torch.float32, torch.bfloat16),
           "bf16": (torch.bfloat16, torch.bfloat16)}


def _close(got, want, mode):
    if mode == "fp32":
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    else:
        _held(got, want, mode)


def _widest(dh, z_size, w_size):
    """The widest N the plan keeps in one cluster at head width ``dh``."""
    n = 64 * k_vita_msa._MSA_MAX_CLUSTER
    while k_vita_msa.msa_plan(n, dh, z_size, w_size).paged:
        n -= 1
    return n


@pytest.mark.parametrize("mode", sorted(_MODES3))
@pytest.mark.parametrize("n", [17, 49, 64, 65, 150, 196, 256, 300, 380,
                               420, "widest"])
def test_vita_msa_batched_every_cluster_size(card, mode, n):
    """Kernel 5 at every cluster size the plan chooses (1-8 blocks of 64
    rows; Dh 64 up to N 256, Dh 32 past it, up to the widest N one
    cluster holds), slices that end ragged, global and windowed, with and
    without qkv_bias, and a head-pruned stack (H*Dh < D)."""
    zt, wt = _MODES3[mode]
    g = torch.Generator(device=card).manual_seed(7)
    dh = 32 if n == "widest" or n > 256 else 64
    if n == "widest":
        n = _widest(dh, zt.itemsize, wt.itemsize)
    plan = k_vita_msa.msa_plan(n, dh, zt.itemsize, wt.itemsize)
    assert plan.paged == 0
    assert plan.cluster <= 8 and (plan.cluster - 1) * plan.rows < n \
        <= plan.cluster * plan.rows
    for h, d in ((2, 96), (1, 96)):          # (1, 96): one head kept
        w = [(torch.randn((h, d, dh), generator=g, device=card)
              * d ** -0.5).to(wt) for _ in range(3)]
        qb = (0.2 * torch.randn((3, h, dh), generator=g,
                                device=card)).to(wt)
        z = torch.randn((4, n, d), generator=g, device=card).to(zt)
        bias = 0.5 * torch.randn((h, n, n), generator=g, device=card)
        mask = torch.where(torch.rand((2, n, n), generator=g, device=card)
                           > 0.7, -1e30, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        for bi, ma, q in ((None, None, None), (None, None, qb),
                          (bias, mask, qb)):
            _close(k_vita_msa.vita_msa_batched(z, *w, bi, ma, q),
                   ref.vita_msa_batched_ref(z, *w, bi, ma, q), mode)


# (B, N, D, H, Dh) on the packed tile (`vita_msa.msa_packed_plan`): TNT-S's
# pixel stream at buckets 8 and 32 and a ragged B, TNT-B's published pixel
# widths, N 32, 7 and 1, Dh 32, and an odd D and Dh (z and bf16 weights
# copied by plain loads).
_PACKED = [(1568, 16, 24, 4, 6), (6272, 16, 24, 4, 6), (1570, 16, 24, 4, 6),
           (40, 16, 40, 4, 10), (12, 32, 24, 4, 6), (45, 7, 24, 4, 6),
           (130, 1, 24, 4, 6), (16, 16, 32, 1, 32), (24, 16, 21, 3, 7)]


@pytest.mark.parametrize("mode", ["fp32", "mixed"])
@pytest.mark.parametrize("b,n,d,h,dh", _PACKED)
def test_packed_msa_tile_matches_plain(card, mode, b, n, d, h, dh):
    """Kernel 5 and kernel 1 (SA merged) on the packed tile, global and,
    where nW 4 divides B, windowed, with and without qkv_bias, against
    their plain versions at the bounds above."""
    zt, wt = _MODES3[mode]
    assert k_vita_msa.msa_packed_plan(n, d, h, dh, 4, wt.itemsize)
    g = torch.Generator(device=card).manual_seed(13)

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g, device=card)).to(wt)

    w = [r(h, d, dh, s=d ** -0.5) for _ in range(3)]
    qb = r(3, h, dh, s=0.2)
    z = torch.randn((b, n, d), generator=g, device=card)
    cases = [(None, None, None), (None, None, qb)]
    if b % 4 == 0:
        bias = 0.5 * torch.randn((h, n, n), generator=g, device=card)
        mask = torch.where(torch.rand((4, n, n), generator=g, device=card)
                           > 0.7, -1e30, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        cases.append((bias, mask, qb))
    for bi, ma, q in cases:
        _close(k_vita_msa.vita_msa_batched(z, *w, bi, ma, q),
               ref.vita_msa_batched_ref(z, *w, bi, ma, q), mode)
    m = 4 * d
    bp = {"wq": w[0], "wk": w[1], "wv": w[2],
          "w_msa": r(h * dh, d, s=(h * dh) ** -0.5),
          "ln1_w": 1 + r(d, s=0.1), "ln1_b": r(d, s=0.1),
          "ln2_w": 1 + r(d, s=0.1), "ln2_b": r(d, s=0.1),
          "w_up": r(d, m, s=d ** -0.5), "b_up": r(m, s=0.1),
          "w_down": r(m, d, s=m ** -0.5), "b_down": r(d, s=0.1)}
    f_args = [z] + [bp[k] for k in _ORDER]
    _close(k_vita_layer.vita_layer(*f_args), ref.vita_layer_ref(*f_args),
           mode)
    if b % 4 == 0:
        _close(k_vita_layer.vita_layer(*f_args, bias, mask),
               ref.vita_layer_ref(*f_args, bias, mask), mode)


@pytest.mark.parametrize("mode", sorted(_MODES3))
@pytest.mark.parametrize("model", ["deit_t", "deit_t_196", "swin_t"])
def test_vita_layer_tensor_core_tiles_match_plain_and_chain(card, mode,
                                                            model):
    """Kernel 1 (LN1, the MSA tile, the split-TF32 GEMMs) at a reduced
    DeiT-T width (D 192, 3 heads) over 16 tokens (one block a cluster)
    and over DeiT-T's 196 (clusters of 4: the distributed shared memory
    gather and SA written merged by several blocks), and a windowed Swin
    block (four shifted 4x4 windows, D 96), against its plain version at
    the mode's bound and against a one-layer group (kernel 7, the same
    tiles in the same order: equal within 1e-6 of the output scale)."""
    xt, wt = _MODES3[mode]
    cfg = dataclasses.replace(vision_registry.build_cfg("deit_t"), layers=1,
                              dtype="float32" if wt == torch.float32
                              else "bfloat16")
    if model == "swin_t":
        cfg = dataclasses.replace(cfg, dim=96)
    g = torch.Generator(device=card).manual_seed(11)
    bp = dict(vit.init_params(cfg, seed=4, device=card)["layers"][0])
    for k in ("ln1_b", "ln2_b", "b_up", "b_down"):
        bp[k] = (bp[k].float() + 0.1 * torch.randn(
            bp[k].shape, generator=g, device=card)).to(wt)
    n = 196 if model == "deit_t_196" else cfg.tokens
    if model == "deit_t_196":
        assert k_vita_msa.msa_plan(n, cfg.head_dim, 4,
                                   wt.itemsize).cluster == 4
    x = torch.randn((2, n, cfg.dim), generator=g, device=card)
    bias = mask = None
    if model == "swin_t":
        x, bias, mask = _windows(card, cfg.heads, cfg.dim)
    f_args = (x.to(xt), *[bp[k] for k in _ORDER], bias, mask)
    got = k_vita_layer.vita_layer(*f_args)
    _close(got, ref.vita_layer_ref(*f_args), mode)
    one = k_vita_layer_group.vita_layer_group(
        f_args[0], *[t[None] for t in f_args[1:13]],
        None if bias is None else bias[None], mask)
    assert float((got.float() - one.float()).abs().max()) \
        <= 1e-6 * float(got.float().abs().max())


@pytest.mark.parametrize("wt", [torch.float32, torch.bfloat16])
def test_float_layer_and_group_accept_the_same_shapes(card, wt):
    """The float layer (kernel 1, the MSA tile) and the float layer group
    (kernel 7, the same tiles) take the same (N, Dh): where the
    tile's plan fits, in one cluster or paged, both run and agree with
    the plain layer; where it does not (Dh past 128, N past the paged
    attention's scores: 704 at Dh 128), both raise ValueError."""
    g = torch.Generator(device=card).manual_seed(5)
    shapes = ((49, 32), (196, 64), (256, 64), (300, 64), (420, 64),
              (196, 80), (40, 128), (480, 32), (513, 32), (196, 129),
              (705, 128))
    accepted = []
    for n, dh in shapes:
        d, m = 2 * dh, 48

        def r(*shape, s=1.0):
            return (s * torch.randn(shape, generator=g, device=card)).to(wt)

        bp = {"wq": r(2, d, dh, s=d ** -0.5), "wk": r(2, d, dh, s=d ** -0.5),
              "wv": r(2, d, dh, s=d ** -0.5),
              "w_msa": r(2 * dh, d, s=d ** -0.5),
              "ln1_w": 1 + r(d, s=0.1), "ln1_b": r(d, s=0.1),
              "ln2_w": 1 + r(d, s=0.1), "ln2_b": r(d, s=0.1),
              "w_up": r(d, m, s=d ** -0.5), "b_up": r(m, s=0.1),
              "w_down": r(m, d, s=m ** -0.5), "b_down": r(d, s=0.1)}
        x = torch.randn((1, n, d), generator=g, device=card)
        args = [bp[k] for k in _ORDER]
        try:
            got = k_vita_layer.vita_layer(x, *args)
        except ValueError:
            got = None
        try:
            grouped = k_vita_layer_group.vita_layer_group(
                x, *[a[None] for a in args])
        except ValueError:
            grouped = None
        assert (got is None) == (grouped is None), (n, dh)
        if got is not None:
            accepted.append((n, dh))
            want = ref.vita_layer_ref(x, *args)
            _close(got, want, "fp32" if wt == torch.float32 else "mixed")
            _close(grouped, want, "fp32" if wt == torch.float32 else "mixed")
    assert (196, 64) in accepted and (49, 32) in accepted
    assert (196, 80) in accepted and (513, 32) in accepted
    assert (196, 129) not in accepted and (705, 128) not in accepted


# ---------------------------------------------------------------------------
# Kernel 4 on the int8 tensor cores (csrc/mma_gemm_i8.cuh)
# ---------------------------------------------------------------------------


def _force_kgroups(monkeypatch, kgroups):
    """Make every kernel 4 launch split its k steps over ``kgroups`` warp
    groups (its plan otherwise as `gemm_i8_plan` gives it)."""
    def plan_for(a, w):
        k, n, ldb, grp, grp_stride = k_int8_matmul.b_layout(w)
        return k_int8_matmul.gemm_i8_plan(
            a.shape[0], n, k, ldb=ldb, grp=grp, grp_stride=grp_stride,
            a_align=a.data_ptr() % 16, b_align=w.data_ptr() % 16,
            kgroups=kgroups)
    monkeypatch.setattr(k_int8_matmul, "plan_for", plan_for)


@pytest.mark.parametrize("kgroups", k_int8_matmul.I8_KGROUPS)
@pytest.mark.parametrize("m,k,n", [(37, 53, 29), (130, 96, 70),
                                   (1, 64, 16), (97, 300, 136)])
def test_int8_gemm_tile_every_out_kind_ragged(card, monkeypatch, kgroups, m,
                                              k, n):
    """Kernel 4's tensor-core tile with one and two k groups, ragged M, N
    and K (one to three 128-deep stages)
    (byte-wide copies where K or N is odd, 4-, 8- and 16-byte ones where
    they divide): int32, rescaled float and requantised int8 outputs, and
    with a float32 or bf16 bias and a residual, each equal to the plain
    version bit for bit; with GELU within fp32 rounding of it."""
    _force_kgroups(monkeypatch, kgroups)
    g = torch.Generator(device=card).manual_seed(3)
    a = torch.randint(-127, 128, (m, k), device=card, generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), device=card, generator=g,
                      dtype=torch.int8)
    assert k_int8_matmul.plan_for(a, w).kgroups == kgroups
    xs = torch.tensor([0.02], device=card)
    ws = torch.rand(n, device=card, generator=g) * 1e-2
    qs = torch.tensor([0.05], device=card)
    res = torch.randn((m, n), device=card, generator=g)
    bias = torch.randn(n, device=card, generator=g)
    scales = {"x_scale": xs, "w_scale": ws}
    cases = [(torch.int32, {}), (torch.float32, scales),
             (torch.int8, dict(scales, out_scale=qs)),
             (torch.float32, dict(scales, bias=bias, res=res)),
             (torch.int8, dict(scales, bias=bias.bfloat16(), out_scale=qs))]
    for out_dtype, kw in cases:
        out = torch.empty((m, n), device=card, dtype=out_dtype)
        got = k_int8_matmul.launch_gemm_i8(a, w, out, **kw)
        assert torch.equal(got, ref.gemm_i8_ref(a, w, out_dtype, **kw)), \
            (out_dtype, sorted(kw))
    kw = dict(scales, bias=bias, res=res, gelu=True)
    got = k_int8_matmul.launch_gemm_i8(a, w, torch.empty((m, n), device=card),
                                       **kw)
    want = ref.gemm_i8_ref(a, w, torch.float32, **kw)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("kgroups", k_int8_matmul.I8_KGROUPS)
@pytest.mark.parametrize("h,dh,chunk", [(4, 24, 8), (3, 64, 16),
                                        (2, 36, 4), (3, 17, 1)])
def test_int8_gemm_tile_reads_ragged_head_stacks_in_place(card, monkeypatch,
                                                          kgroups, h, dh,
                                                          chunk):
    """Kernel 4 reading a per-head (H, K, Dh) stack in place: 16-byte
    chunks only where Dh keeps them inside one head and aligned (Dh 64),
    8- or 4-byte ones where Dh allows them (24, 36), bytes where it does
    not (17); the int32 and requantised outputs equal the plain version
    on the merged (K, H*Dh) matrix, with one and two k groups."""
    _force_kgroups(monkeypatch, kgroups)
    g = torch.Generator(device=card).manual_seed(4)
    k, m = 96, 75
    a = torch.randint(-127, 128, (m, k), device=card, generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (h, k, dh), device=card, generator=g,
                      dtype=torch.int8)
    assert k_int8_matmul.plan_for(a, w).b_chunk == chunk
    xs = torch.tensor([0.03], device=card)
    ws = torch.rand(h * dh, device=card, generator=g) * 1e-2
    out32 = k_int8_matmul.launch_gemm_i8(
        a, w, torch.empty((m, h * dh), device=card, dtype=torch.int32))
    assert torch.equal(out32, ref.gemm_i8_ref(a, w, torch.int32))
    got = k_int8_matmul.launch_gemm_i8(
        a, w, torch.empty((m, h * dh), device=card), x_scale=xs, w_scale=ws)
    assert torch.equal(got, ref.gemm_i8_ref(a, w, torch.float32, xs, ws))


# The int8 chains' attention tile (csrc/attention.cuh, kernels 2, 3 and 8)
# launched alone against `ref.softmax_av` on the same fp32 Q, K and V: a
# float32 output within 1e-4 of its scale (fp32-accurate split TF32 against
# fp32 dots: reassociation only), an int8 one within one code of the plain
# output quantised at the same scale, on at most 0.1% of the codes (a flip
# at a rounding boundary).  Layouts: "merged" (B*N, H*Dh), as kernel 2 and
# kernel 3's projections give them; "heads" (B, H, N, Dh), kernel 3's
# output.


def _swin_terms(card, h, g):
    """Swin-T stage 1's window terms: the (H, 49, 49) relative-position
    bias and the shifted (64, 49, 49) mask of a 56x56 grid of 7x7
    windows."""
    ph = sched.Phase(kind="msa", path=(), site="", grid=(56, 56), window=7,
                     shift=3)
    bp = {"rel_bias": 0.5 * torch.randn((169, h), generator=g, device=card)}
    return sched._window_terms(ph, bp, card)


def _strides(h, n, dh, layout):
    """The (image, token, head) element strides of ``layout``."""
    return (h * n * dh, dh, n * dh) if layout == "heads" else \
        (n * h * dh, h * dh, dh)


@pytest.mark.parametrize("out_kind", ["float32", "int8"])
@pytest.mark.parametrize("b,h,n,dh,windowed,ins,outs", [
    (128, 3, 49, 32, True, "merged", "merged"),     # Swin-T stage 1, nW 64
    (8, 3, 197, 64, False, "merged", "heads"),      # DeiT-T, kernel 3
    (8, 3, 197, 64, False, "merged", "merged"),     # DeiT-T, kernels 2, 8
    (2, 4, 50, 64, False, "heads", "heads"),
    (2, 2, 257, 32, False, "merged", "merged"),
    (1, 2, 400, 64, False, "merged", "heads"),      # a 2-slot ring
    (2, 3, 50, 30, False, "merged", "heads"),       # Dh 30: plain loads
    (1, 1, 1216, 64, False, "heads", "merged")])    # the widest N at Dh 64
def test_attention_tile_matches_softmax_av(card, b, h, n, dh, windowed, ins,
                                           outs, out_kind):
    g = torch.Generator(device=card).manual_seed(n + dh)
    q, k, v = (torch.randn((b, h, n, dh), generator=g, device=card)
               for _ in range(3))
    bias, mask = _swin_terms(card, h, g) if windowed else (None, None)
    want = ref.softmax_av(q, k, v, scale=dh ** -0.5, bias=bias, mask=mask)
    qi, ki, vi = (t.contiguous() if ins == "heads"
                  else t.transpose(1, 2).contiguous() for t in (q, k, v))
    shape = (b, h, n, dh) if outs == "heads" else (b, n, h, dh)
    scale = want.abs().max().reshape(1) / 127.0
    int8 = out_kind == "int8"
    out = torch.empty(shape, device=card,
                      dtype=torch.int8 if int8 else torch.float32)
    k_vita_msa.launch_attention(qi, ki, vi, out, b=b, h=h, n=n, dh=dh,
                                in_strides=_strides(h, n, dh, ins),
                                out_strides=_strides(h, n, dh, outs),
                                out_scale=scale if int8 else None,
                                bias=bias, mask=mask)
    got = out if outs == "heads" else out.transpose(1, 2)
    if int8:
        diff = (got.int() - ref.quant(want, scale).int()).abs()
        assert int(diff.max()) <= 1
        assert int((diff > 0).sum()) <= max(4, diff.numel() // 1000)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(
            1.0, float(want.abs().max())))


# ---------------------------------------------------------------------------
# The widened tiles: heads of 96 and 128 at ViT-B's 197 tokens, and
# ViT-B/16 at 384 px (576 patches, 577 with the class token) at heads of
# 64, through every kernel that runs them (1, 2, 3, 5, 7 and 8), in every
# mode, against the plain versions at the bounds above; the groups against
# their chains (float within 1e-6 of the scale, equal in practice; int8
# exactly).
# ---------------------------------------------------------------------------

_WIDE = [(197, 96), (197, 128), (576, 64), (577, 64)]


def _wide_block(card, n, dh, wt, seed, h=2, b=2):
    """A block of ``h`` heads of ``dh`` (D = h * dh, M = 2 D) with
    non-zero LN vectors and biases in ``wt``, and x (b, n, D)."""
    g = torch.Generator(device=card).manual_seed(seed)
    d, m = h * dh, 4 * dh

    def r(*shape, s=1.0):
        return (s * torch.randn(shape, generator=g, device=card)).to(wt)

    bp = {"wq": r(h, d, dh, s=d ** -0.5), "wk": r(h, d, dh, s=d ** -0.5),
          "wv": r(h, d, dh, s=d ** -0.5), "w_msa": r(h * dh, d, s=d ** -0.5),
          "ln1_w": 1 + r(d, s=0.1), "ln1_b": r(d, s=0.1),
          "ln2_w": 1 + r(d, s=0.1), "ln2_b": r(d, s=0.1),
          "w_up": r(d, m, s=d ** -0.5), "b_up": r(m, s=0.1),
          "w_down": r(m, d, s=m ** -0.5), "b_down": r(d, s=0.1)}
    return bp, torch.randn((b, n, d), generator=g, device=card)


def _int8_args(card, x, bp, vt=torch.float32):
    """The int8 layer's operands from a float block (per-head and
    per-channel weight scales, fixed activation scales), LN vectors and
    biases in ``vt``."""
    h, _, dh = bp["wq"].shape
    q = quantize_vision_params({k: v.float() for k, v in bp.items()})
    acts = torch.tensor([4.0, 2.0, 4.0, 3.0], device=card) / 127.0
    return (x, q["wq"].values, q["wk"].values, q["wv"].values,
            q["w_msa"].values, q["w_up"].values, q["w_down"].values, acts,
            *[q[k].scale.reshape(h, dh) for k in ("wq", "wk", "wv")],
            *[q[k].scale.reshape(-1) for k in ("w_msa", "w_up", "w_down")],
            *[bp[k].float().to(vt) for k in ("ln1_w", "ln1_b", "ln2_w",
                                             "ln2_b", "b_up", "b_down")])


@pytest.mark.parametrize("mode", sorted(_MODES3))
@pytest.mark.parametrize("n,dh", _WIDE)
def test_wide_float_msa_and_layer_match_plain(card, mode, n, dh):
    """Kernels 5 and 1 under the paged plan (the projection, then the
    attention tile; bf16 mode: P and V rounded to bf16), global and
    windowed with qkv_bias, against their plain versions."""
    zt, wt = _MODES3[mode]
    assert k_vita_msa.msa_plan(n, dh, zt.itemsize, wt.itemsize).paged
    bp, x = _wide_block(card, n, dh, wt, seed=n + dh)
    h = bp["wq"].shape[0]
    g = torch.Generator(device=card).manual_seed(dh)
    w = (bp["wq"], bp["wk"], bp["wv"])
    qb = (0.2 * torch.randn((3, h, dh), generator=g, device=card)).to(wt)
    bias = 0.5 * torch.randn((h, n, n), generator=g, device=card)
    mask = torch.where(torch.rand((2, n, n), generator=g, device=card)
                       > 0.7, -1e30, 0.0)
    mask.diagonal(dim1=1, dim2=2).zero_()
    z = x.to(zt)
    for bi, ma, q in ((None, None, None), (bias, mask, qb)):
        _close(k_vita_msa.vita_msa_batched(z, *w, bi, ma, q),
               ref.vita_msa_batched_ref(z, *w, bi, ma, q), mode)
    f_args = (x.to(zt), *[bp[k] for k in _ORDER])
    _close(k_vita_layer.vita_layer(*f_args, bias, mask),
           ref.vita_layer_ref(*f_args, bias, mask), mode)


@pytest.mark.parametrize("vt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,dh", _WIDE)
def test_wide_int8_layer_msa_and_attention_match_plain(card, vt, n, dh):
    """Kernels 2 and 3 (the attention tile at DP 128, or at N 576/577)
    with fp32 and bf16 LN vectors, global and windowed with qkv_bias."""
    bp, x = _wide_block(card, n, dh, torch.float32, seed=2 * n + dh)
    args = _int8_args(card, x, bp, vt)
    h = bp["wq"].shape[0]
    g = torch.Generator(device=card).manual_seed(dh + 1)
    bias = 0.5 * torch.randn((h, n, n), generator=g, device=card)
    mask = torch.where(torch.rand((2, n, n), generator=g, device=card)
                       > 0.7, -1e30, 0.0)
    mask.diagonal(dim1=1, dim2=2).zero_()
    for bi, ma in ((None, None), (bias, mask)):
        want = ref.vita_layer_int8_ref(*args, bi, ma)
        got = k_vita_layer.vita_layer_int8(*args, bi, ma)
        assert float((got - want).abs().max()) <= \
            0.02 * float(want.abs().max())
    zq = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    qb = (0.1 * torch.randn((3, h, dh), generator=g, device=card)).to(vt)
    for bi, ma, q in ((None, None, None), (bias, mask, qb)):
        m_args = (zq, *args[1:4], torch.tensor(0.03, device=card),
                  *args[8:11], bi, ma, q)
        want = ref.vita_msa_int8_ref(*m_args)
        torch.testing.assert_close(k_vita_msa.vita_msa_int8(*m_args), want,
                                   rtol=0,
                                   atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("wide", ["dh128", "n577"])
@pytest.mark.parametrize("mode", sorted(_MODES3))
def test_wide_groups_match_plain_and_chain(card, mode, wide):
    """Kernels 7 and 8 over two layers at Dh 128 (N 197) and at N 577 (Dh
    64): against their plain versions, and against two calls of the
    per-layer chain on the group's tiles (`vita_layer_group.tile_chain`:
    the same projection, attention and GEMM tiles in the same order), the
    float group bit for bit with fp32 x, the int8 group exactly (two calls
    of `vita_layer_int8`).  Kernel 1 itself, whose fp32-weight products
    take the wgmma tile, within 1e-6 of the group's scale."""
    xt, wt = _MODES3[mode]
    n, dh = (197, 128) if wide == "dh128" else (577, 64)
    blocks, x = [], None
    for l in range(2):
        bp, x0 = _wide_block(card, n, dh, wt, seed=10 * l + dh, b=1)
        blocks.append(bp)
        x = x0 if x is None else x
    sp = {k: torch.stack([bp[k] for bp in blocks]) for k in _ORDER}
    f_args = [x.to(xt)] + [sp[k] for k in _ORDER]
    got = k_vita_layer_group.vita_layer_group(*f_args)
    _close(got, ref.vita_layer_group_ref(*f_args), mode)
    y, tiles = f_args[0], f_args[0]
    for bp in blocks:
        y = k_vita_layer.vita_layer(y, *[bp[k] for k in _ORDER])
        tiles = k_vita_layer_group.tile_chain(tiles, *[bp[k] for k in _ORDER])
    if xt == torch.float32:
        assert torch.equal(got, tiles)
        assert float((got - y).abs().max()) <= 1e-6 * float(got.abs().max())
    if mode == "bf16":
        return
    per = [_int8_args(card, x, bp) for bp in blocks]
    i_args = [x] + [torch.stack([p[i] for p in per])
                    for i in range(1, len(per[0]))]
    got = k_vita_layer_group.vita_layer_group_int8(*i_args)
    want = ref.vita_layer_group_int8_ref(*i_args)
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    y = x
    for l in range(2):
        y = k_vita_layer.vita_layer_int8(y, *[a[l] for a in i_args[1:]])
    assert torch.equal(got, y)


# TNT-S's two streams at bucket 8: inner 1,568 sequences (8 images x 196
# patches) of 16 pixel tokens, D 24, 4 heads of Dh 6, M 96; outer 8 images
# of N 196, D 384, 6 heads of 64, M 1,536.  (B, N) of each.
_TNT = {"inner": (1568, 16), "outer": (8, 196)}


def _tnt_block(card, stream, wt, seed=3):
    """A TNT-S block of ``stream`` from the model's init (seed ``seed``)
    with non-zero LN vectors and biases, in ``wt``, and x (B, N, D)."""
    cfg = vision_registry.build_cfg("tnt_s", full=True)
    bp = dict(tnt.init_params(dataclasses.replace(cfg, layers=1), seed,
                              card)["layers"][0][stream])
    g = torch.Generator(device=card).manual_seed(seed)
    for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "b_up", "b_down"):
        bp[k] = bp[k] + 0.1 * torch.randn(bp[k].shape, generator=g,
                                          device=card)
    b, n = _TNT[stream]
    x = torch.randn((b, n, bp["wq"].shape[1]), generator=g, device=card)
    return {k: v.to(wt) for k, v in bp.items()}, x


@pytest.mark.parametrize("mode", sorted(_MODES3))
@pytest.mark.parametrize("stream", sorted(_TNT))
def test_tnt_float_kernels_match_plain(card, stream, mode):
    """Kernels 1, 5 and 6 at TNT-S's inner stream (Dh 6 padded to the
    tile's 32, D 24 a partial k step, 16 of 64 rows valid) and outer
    stream, in each dtype mode, against their plain versions."""
    xt, wt = _MODES3[mode]
    bp, x = _tnt_block(card, stream, wt)
    x = x.to(xt)
    f_args = [x] + [bp[k] for k in _ORDER]
    _close(k_vita_layer.vita_layer(*f_args), ref.vita_layer_ref(*f_args),
           mode)
    z = ops.layer_norm(x, bp["ln1_w"], bp["ln1_b"])
    w = (bp["wq"], bp["wk"], bp["wv"])
    _close(k_vita_msa.vita_msa_batched(z, *w),
           ref.vita_msa_batched_ref(z, *w), mode)
    mlp = (bp["w_up"], bp["b_up"], bp["w_down"], bp["b_down"])
    _close(k_fused_mlp.fused_mlp(z, mlp[0], mlp[2], mlp[1], mlp[3]),
           ref.fused_mlp_ref(z, *mlp), mode)


@pytest.mark.parametrize("vt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stream", sorted(_TNT))
def test_tnt_int8_kernels_match_plain(card, stream, vt):
    """Kernels 2 and 3 at TNT-S's two streams (LN vectors and biases in
    ``vt``) against their plain versions, and kernel 4 exactly at the
    stream's products outside them: the pixel embed (25,088 x 48 x 24)
    and the inner MLP's (K 24 and 96), or the fold (1,568 x 384 x 384)."""
    bp, x = _tnt_block(card, stream, torch.float32)
    i_args = _int8_args(card, x, bp, vt)
    want = ref.vita_layer_int8_ref(*i_args)
    got = k_vita_layer.vita_layer_int8(*i_args)
    assert float((got - want).abs().max()) <= 0.02 * float(want.abs().max())
    zq = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    m_args = (zq, *i_args[1:4], torch.tensor(0.03, device=card),
              *i_args[8:11])
    want = ref.vita_msa_int8_ref(*m_args)
    torch.testing.assert_close(k_vita_msa.vita_msa_int8(*m_args), want,
                               rtol=0, atol=1e-4 * float(want.abs().max()))
    g = torch.Generator(device=card).manual_seed(4)
    shapes = ([(25088, 48, 24), (25088, 24, 96), (25088, 96, 24)]
              if stream == "inner" else [(1568, 384, 384)])
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), device=card, generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), device=card, generator=g,
                          dtype=torch.int8)
        assert torch.equal(k_int8_matmul.int8_matmul(a, w),
                           ref.int8_matmul_ref(a, w))
        xs, ws = torch.tensor(0.03, device=card), torch.rand(n, device=card)
        assert torch.equal(k_int8_matmul.int8_matmul(a, w, xs, ws),
                           ref.int8_matmul_ref(a, w, xs, ws))


@pytest.mark.parametrize("name,mode", [("tnt_s", "float"), ("tnt_s", "int8"),
                                       ("tnt_s_p", "float")])
def test_tnt_server_on_the_card_matches_the_cpu(card, name, mode):
    """Full-size TNT-S (and TNT-S-p) served fused through `VisionServer`
    on the card, launch counts as the schedule says, logits against the
    same server on the CPU (float 1e-3, int8 2% of the logit scale)."""
    sc = vision_serve.ServeConfig(mode=mode, buckets=(1, 4), calib_images=4,
                                  full=True)
    server = vision_serve.make_server(name, sc)
    images = np.random.default_rng(0).standard_normal(
        (5, 224, 224, 3)).astype(np.float32)
    twin = vision_serve.make_server(
        name, dataclasses.replace(sc, device="cpu"),
        params=vit.to_device(server.params, "cpu"),
        qparams=None if server.qparams is None
        else vit.to_device(server.qparams, "cpu"),
        calibrator=server.calibrator)
    ops.reset_launches()
    got = server.submit_many(images)
    server.run()
    kernel = "vita_layer" if mode == "float" else "vita_layer_int8"
    assert ops.LAUNCHES[kernel] == 2 * 24          # 2 micro-batches
    want = twin.submit_many(images)
    twin.run()
    g = np.stack([r.logits for r in got])
    w = np.stack([r.logits for r in want])
    assert g.shape == (5, 1000) and np.isfinite(g).all()
    tol = (1e-3 if mode == "float" else 2e-2) * np.abs(w).max()
    assert np.abs(g - w).max() <= tol


@pytest.mark.parametrize("mode,group", [("float", 1), ("int8", 1),
                                        ("float", 4), ("int8", 4)])
def test_full_ring_matches_one_micro_batch_at_a_time(card, mode, group):
    """Three micro-batches dispatched back to back, none completed, each
    `dispatch` under ``set_sync_debug_mode("error")`` (a host sync in the
    staging, the copy or the forward raises), give the logits of the same
    micro-batches dispatched and completed one at a time, bit for bit (the
    same kernels on the same inputs); padding counts in ``n_padded``."""
    sc = vision_serve.ServeConfig(mode=mode, buckets=(2, 4), calib_images=4,
                                  fuse_group=group)
    server = vision_serve.make_server("deit_t", sc)
    images = np.random.default_rng(0).standard_normal(
        (10, 64, 64, 3)).astype(np.float32)
    groups = [images[:4], images[4:8], images[8:]]

    def reqs(ims):
        return [vision_serve.VisionRequest(i, im) for i, im in enumerate(ims)]
    one_at_a_time = []
    for ims in groups:                 # also warms every bucket up
        inflight = server.dispatch(reqs(ims))
        server.complete(inflight)
        one_at_a_time.append(np.stack([r.logits for r in inflight.requests]))
    padded0 = server.n_padded
    ring = []
    try:
        torch.cuda.set_sync_debug_mode("error")
        for ims in groups:
            ring.append(server.dispatch(reqs(ims)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert server.n_padded - padded0 == 0 and ring[2].bucket == 2
    for inflight, want in zip(ring, one_at_a_time):
        server.complete(inflight)
        got = np.stack([r.logits for r in inflight.requests])
        np.testing.assert_array_equal(got, want)
    server.complete(server.dispatch(reqs(images[:3])))
    assert server.n_padded - padded0 == 1


def test_ring_read_back_through_pinned_copies_matches_run(card):
    """Full-size DeiT-T, buckets 4 and 8: three micro-batches of distinct
    images dispatched back to back on one server, then completed in order
    with the tracer on, give every request the logits a second server on
    the card gives the same images through `run`, bit for bit; each
    micro-batch's logits came through the asynchronous pinned copy
    (``vita.server.readback`` a0 1), and stay as they were after three
    more micro-batches have reused the pinned blocks."""
    sc = vision_serve.ServeConfig(buckets=(4, 8), full=True)
    server = vision_serve.make_server("deit_t", sc)
    twin = vision_serve.make_server("deit_t", sc, params=server.params)
    rng = np.random.default_rng(5)
    images = rng.standard_normal((19, 224, 224, 3)).astype(np.float32)
    want = twin.submit_many(images)                # 8 + 8 + 3 (bucket 4)
    twin.run()
    server.submit_many(images[:4])
    server.run()

    def ring(ims):
        got = server.submit_many(ims)
        inflights = [server.dispatch() for _ in range(3)]
        assert [f.bucket for f in inflights] == [8, 8, 4]
        for inflight in inflights:
            server.complete(inflight)
        return got
    trace.disable()
    trace.reset()
    trace.enable(cap=100_000)
    try:
        got = ring(images)
    finally:
        trace.disable()
    records = trace.records()
    trace.reset()
    readbacks = records.rows("vita.server.readback")
    assert len(readbacks) == 3
    assert (records.column("a0")[readbacks] == 1).all()
    w = np.stack([r.logits for r in want])
    g = np.stack([r.logits for r in got])
    assert g.shape == (19, 1000) and np.isfinite(g).all()
    np.testing.assert_array_equal(g, w)
    ring(rng.standard_normal((19, 224, 224, 3)).astype(np.float32))
    np.testing.assert_array_equal(np.stack([r.logits for r in got]), g)


# ---------------------------------------------------------------------------
# The gradient path of kernels 9, 6 and 11 (training)
# ---------------------------------------------------------------------------


def _grad_cases(card, dtype):
    """(launch name, the wrapper call, the plain call, inputs) at small
    training shapes: GQA attention with a window, the gated SiLU MLP at
    many rows, the RG-LRU recurrence past one chunk."""
    g = torch.Generator(device=card).manual_seed(9)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=card)).to(
            dtype).requires_grad_()
    q, k, v = r(2, 4, 70, 80), r(2, 2, 70, 80), r(2, 2, 70, 80)
    x, w1, w2, wg = (r(3, 40, 96), r(96, 200, scale=0.1),
                     r(200, 96, scale=0.1), r(96, 200, scale=0.1))
    a = (0.5 + 0.49 * torch.rand((2, 77, 130), generator=g,
                                 device=card)).requires_grad_()
    b = torch.randn((2, 77, 130), generator=g, device=card).requires_grad_()
    return [
        ("flash_attention",
         lambda q, k, v: ops.attention(q, k, v, window=32),
         lambda q, k, v: ref.attention_ref(q, k, v, window=32), (q, k, v)),
        ("fused_mlp",
         lambda x, w1, w2, wg: ops.mlp(x, w1, w2, w_gate=wg,
                                       activation="silu"),
         lambda x, w1, w2, wg: ref.fused_mlp_ref(x, w1, None, w2, None,
                                                 activation="silu",
                                                 w_gate=wg),
         (x, w1, w2, wg)),
        ("rglru_scan", ops.linear_recurrence, ref.linear_recurrence_ref,
         (a, b)),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gradients_equal_the_plain_versions(card, dtype):
    """Forward through the kernel (one launch, counted), backward through
    `ops._KernelGrad`: every input's gradient equals autograd of the
    plain version on the same inputs (the backward recomputes it)."""
    for name, fn, plain, inputs in _grad_cases(card, dtype):
        before = ops.LAUNCHES[name]
        out = fn(*inputs)
        assert ops.LAUNCHES[name] == before + 1
        assert type(out.grad_fn).__name__ == "_KernelGradBackward"
        want = plain(*inputs)
        _lm_close(out.detach(), want.detach())
        ct = torch.randn_like(out)
        got = torch.autograd.grad(out, inputs, ct)
        exp = torch.autograd.grad(want, inputs, ct)
        for gi, ei in zip(got, exp):
            assert gi.dtype == ei.dtype
            torch.testing.assert_close(gi, ei, rtol=0, atol=0)


def test_serving_calls_launch_without_the_autograd_function(card):
    """Inputs that take no gradient, `no_grad` and `inference_mode` launch
    the kernel directly: no graph node, one launch each."""
    for name, fn, _, inputs in _grad_cases(card, torch.bfloat16):
        detached = [t.detach() for t in inputs]
        for ctx, args in ((torch.enable_grad, detached),
                          (torch.no_grad, inputs),
                          (torch.inference_mode, inputs)):
            before = ops.LAUNCHES[name]
            with ctx():
                out = fn(*args)
            assert out.grad_fn is None and ops.LAUNCHES[name] == before + 1


def test_danube_train_step_on_the_card_matches_the_cpu(card):
    """The reduced Danube in float32 (kernels 6 and 9 forward, their plain
    versions' gradients): the loss and every gradient leaf on the card
    against the CPU at the same weights and batch (1e-4 of each leaf's
    scale: fp32 reassociation in the kernels), and the card's AdamW step
    against the CPU's on the card's own gradients (1e-6: the same
    elementwise arithmetic; Adam's step is ill-conditioned where a
    gradient is near 0, so the two devices' gradients are not fed to
    it)."""
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models.layers import to_device
    cfg = configs.get("h2o-danube-1.8b").reduced()
    params = transformer.init_params(cfg, 0)
    batch = SyntheticLM(cfg.vocab, 32, 2, seed=0).batch_at(0)
    got, want = (steps.loss_and_grads(
        to_device(params, dev), {k: torch.from_numpy(v).to(dev)
                                 for k, v in batch.items()}, cfg)
        for dev in (card, "cpu"))
    assert abs(float(got[0]) - float(want[0])) <= 1e-4 * float(want[0])
    for path, g in tree_lib.leaves_with_path(got[2]):
        w = tree_lib.at(want[2], path)
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max()), path
    card_params = to_device(params, card)
    state = steps.init_opt_state(card_params)
    new_p, new_s, _ = steps.apply_grads(got[2], card_params, state, 1e-3)
    cpu_p, cpu_s, _ = steps.apply_grads(
        to_device(got[2], "cpu"), params, steps.init_opt_state(params), 1e-3)
    for a, b in ((new_p, cpu_p), (new_s["adam"]["m"], cpu_s["adam"]["m"]),
                 (new_s["adam"]["v"], cpu_s["adam"]["v"])):
        for path, x in tree_lib.leaves_with_path(a):
            y = tree_lib.at(b, path)
            assert float((x.cpu() - y).abs().max()) <= 1e-6 * float(
                y.abs().max()), path


# ---------------------------------------------------------------------------
# Kernel 1's gradient path, the generic PTQ on kernel 4, DeiT-S served
# ---------------------------------------------------------------------------


def test_vita_layer_gradient_equals_the_plain_version(card):
    """Kernel 1 with inputs that take a gradient: one launch through
    `ops._KernelGrad`, every input's gradient bit for bit autograd of the
    plain version; without one (no_grad, inference_mode, detached) the
    kernel launches directly."""
    _, bp, x = _layer(card)
    args = (x, bp["wq"], bp["wk"], bp["wv"], bp["w_msa"], bp["ln1_w"],
            bp["ln1_b"], bp["ln2_w"], bp["ln2_b"], bp["w_up"], bp["b_up"],
            bp["w_down"], bp["b_down"])
    inputs = tuple(t.detach().requires_grad_() for t in args)
    before = ops.LAUNCHES["vita_layer"]
    out = ops.vita_layer_fused(*inputs)
    assert ops.LAUNCHES["vita_layer"] == before + 1
    assert type(out.grad_fn).__name__ == "_KernelGradBackward"
    want = ref.vita_layer_ref(*inputs)
    torch.testing.assert_close(out.detach(), want.detach(), rtol=0,
                               atol=1e-4 * float(want.detach().abs().max()))
    ct = torch.randn_like(out)
    for got, exp in zip(torch.autograd.grad(out, inputs, ct),
                        torch.autograd.grad(want, inputs, ct)):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)
    for ctx, a in ((torch.no_grad, inputs), (torch.inference_mode, inputs),
                   (torch.enable_grad, args)):
        before = ops.LAUNCHES["vita_layer"]
        with ctx():
            y = ops.vita_layer_fused(*a)
        assert y.grad_fn is None and ops.LAUNCHES["vita_layer"] == before + 1


def test_quantized_linear_on_kernel_4_equals_its_plain_version(card):
    """`quantized_linear` (kernel 4, no fused rescale) against the plain
    int8 matmul on the same inputs: the int32 accumulators and the
    outputs equal, bf16 x lifted by the float32 scale."""
    from repro_torch.core import quant

    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((3, 70, 96), generator=g, device=card).bfloat16()
    w = torch.randn((96, 130), generator=g, device=card) * 0.1
    wq = quant.quantize_per_channel(w)
    act = quant.amax_scale(x.float())
    bias = torch.randn(130, generator=g, device=card)
    accs = {}

    def spy(name, fn):
        def run(xq, wv):
            accs[name] = fn(xq, wv)
            return accs[name]
        return run

    before = ops.LAUNCHES["int8_matmul"]
    y = quant.quantized_linear(x, wq, bias, act,
                               matmul=spy("card", quant._kernel_matmul))
    assert ops.LAUNCHES["int8_matmul"] == before + 1
    y_plain = quant.quantized_linear(x, wq, bias, act,
                                     matmul=spy("plain",
                                                quant.int8_matmul_ref))
    assert accs["card"].dtype == torch.int32
    assert torch.equal(accs["card"], accs["plain"])
    assert torch.equal(y, y_plain)
    assert torch.equal(y, quant.quantized_linear(x, wq, bias, act))


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_deit_s_served_on_the_card_matches_the_cpu(card, mode):
    """DeiT-S at full size served fused through `VisionServer` on the
    card: one kernel 1 (float) or kernel 2 (int8) launch a layer a
    micro-batch, logits against the same server on the CPU (float 1e-3,
    int8 2% of the logit scale)."""
    cfg = vit.deit_s()
    params = vit.init_params(cfg, 0, card)
    images = np.random.default_rng(0).standard_normal(
        (5, 224, 224, 3)).astype(np.float32)
    qparams = cal = None
    if mode == "int8":
        qparams = vit.quantize_vit(params)
        cal = vision_serve.calibrate(qparams, cfg, images[:4], device=card,
                                     n_batches=2)
    sc = vision_serve.ServeConfig(mode=mode, buckets=(1, 4))
    server = vision_serve.VisionServer(cfg, params, serve_cfg=sc,
                                       qparams=qparams, calibrator=cal)
    twin = vision_serve.VisionServer(
        cfg, vit.to_device(params, "cpu"),
        serve_cfg=dataclasses.replace(sc, device="cpu"),
        qparams=None if qparams is None else vit.to_device(qparams, "cpu"),
        calibrator=cal)
    ops.reset_launches()
    got = server.submit_many(images)
    server.run()
    kernel = "vita_layer" if mode == "float" else "vita_layer_int8"
    assert ops.LAUNCHES[kernel] == 2 * 12          # 2 micro-batches
    want = twin.submit_many(images)
    twin.run()
    g = np.stack([r.logits for r in got])
    w = np.stack([r.logits for r in want])
    assert g.shape == (5, 1000) and np.isfinite(g).all()
    tol = (1e-3 if mode == "float" else 2e-2) * np.abs(w).max()
    assert np.abs(g - w).max() <= tol


def test_tnt_s_forward_counts_its_msa_tiles_rows(card):
    """TNT-S's widths at two layers, two images: each layer launches the
    packed MSA tile on 392 sequences of 16 pixel tokens (4 heads of 6, 98
    blocks of four sequences, no padded row) and the cluster tile on 2 of
    196 patches (6 heads of 64, four 64-row blocks each)."""
    cfg = tnt.TNTConfig(name="tnt_s_rows", image=224, patch=16,
                        inner_patch=4, dim=384, inner_dim=24, heads=6,
                        inner_heads=4, layers=2, n_classes=10)
    params = tnt.init_params(cfg, seed=0, device=card)
    images = torch.randn((2, 224, 224, 3), device=card)
    trace.disable()
    trace.reset()
    trace.enable(cap=1_000)
    try:
        with torch.no_grad():
            tnt.forward(params, vit.extract_patches(images, 16), cfg)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    layers = [s for s in trace.records().spans()
              if s.name == "vita.kernels.vita_layer"]
    c = trace.counters()
    trace.reset()
    assert [(s.a0, s.a1) for s in layers] == [(16, 392), (196, 2)] * 2
    assert c["kernels.msa_rows"] == 2 * (392 * 4 * 16 + 2 * 6 * 196)
    assert c["kernels.msa_tile_rows"] == 2 * (392 * 4 * 16 + 2 * 6 * 256)
    assert c["kernels.msa_packed_rows"] == 2 * 392 * 4 * 16


# Kernel 1's fp32 GEMM on the wgmma route (csrc/gemm_wgmma.cu): against a
# float64 product in every epilogue (bias, GELU, an fp32 or bf16 residual
# and output) at ragged M, N and K and at the cells' shapes; deterministic
# and independent of the bucket; and `vita_layer` on that route against
# its plain version.  fp32 outputs within 1e-6 of the output scale (split
# TF32 is fp32-accurate: measured 1.4e-7), bf16 outputs within one bf16
# rounding (2^-8 of the value) of it.
_WG_RAGGED = [(37, 29, 52), (200, 130, 100), (129, 97, 36), (1000, 24, 24)]
_WG_CELLS = [(6272, 384, 384), (6272, 1536, 384), (6272, 384, 1536),
             (25088, 96, 96), (25088, 24, 96), (196, 384, 1536)]


def _wg_operands(card, m, n, k, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.randn((m, k), generator=g, device=card)
    w = torch.randn((k, n), generator=g, device=card) * k ** -0.5
    bias = 0.5 * torch.randn((n,), generator=g, device=card)
    res = torch.randn((m, n), generator=g, device=card)
    return a, w, bias, res


def _wg_want(a, w, bias, res, gelu):
    y = a.double() @ w.double()
    if bias is not None:
        y = y + bias.double()
    if gelu:
        y = torch.nn.functional.gelu(y, approximate="tanh")
    return y if res is None else res.double() + y


def _wg_held(got, want):
    scale = float(want.abs().max())
    err = (got.double() - want).abs()
    if got.dtype == torch.float32:
        assert float(err.max()) <= 1e-6 * scale
    else:
        assert torch.all(err <= 2.0 ** -8 * want.abs() + 1e-6 * scale)


@pytest.mark.parametrize("ot", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rt", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epi", ["none", "bias", "bias_gelu"])
@pytest.mark.parametrize("mnk", _WG_RAGGED)
def test_wgmma_gemm_matches_float64_in_every_epilogue(card, mnk, epi, rt,
                                                      ot):
    m, n, k = mnk
    a, w, bias, res = _wg_operands(card, m, n, k, seed=m + n + k)
    bias = None if epi == "none" else bias
    res = None if rt is None else res.to(rt)
    gelu = epi == "bias_gelu"
    assert k_vita_layer.layer_gemm_plan(a, w) is not None
    out = torch.empty((m, n), device=card, dtype=ot)
    k_vita_layer.launch_wgmma_gemm(a, w, out, bias=bias, res=res, gelu=gelu)
    torch.cuda.synchronize()
    _wg_held(out, _wg_want(a, w, bias, res, gelu))


@pytest.mark.parametrize("mnk", _WG_CELLS)
def test_wgmma_gemm_at_the_cells_shapes(card, mnk):
    """Each product at its plan's tile, and every tile the plan can pick
    (64 or 128 rows by 32, 64 or 96 columns): up's bias and GELU, down's
    bias and residual."""
    m, n, k = mnk
    a, w, bias, res = _wg_operands(card, m, n, k, seed=k)
    want = _wg_want(a, w, bias, res, True)
    out = torch.empty((m, n), device=card)
    k_vita_layer.launch_wgmma_gemm(a, w, out, bias=bias, res=res, gelu=True)
    torch.cuda.synchronize()
    _wg_held(out, want)
    for bn, consumers in k_vita_layer.WG_STAGE_US:
        bm = 64 * consumers
        stages = k_vita_layer.WG_MAX_STAGES
        while k_vita_layer.wgmma_smem(bm, bn, stages) > \
                k_vita_layer.SMEM_LIMIT:
            stages -= 1
        tiles = -(-m // bm) * -(-n // bn)
        plan = k_vita_layer.WgmmaPlan(bm, bn, consumers, stages, tiles,
                                      -(-tiles // 132),
                                      k_vita_layer.wgmma_smem(bm, bn, stages))
        got = torch.empty((m, n), device=card)
        k_vita_layer.launch_wgmma_gemm(a, w, got, bias=bias, res=res,
                                       gelu=True, plan=plan)
        torch.cuda.synchronize()
        _wg_held(got, want)
        # the k order is the tile's business nowhere: every tile, equal
        assert torch.equal(got, out)


def test_wgmma_gemm_is_deterministic_and_independent_of_the_bucket(card):
    """Two calls give the same bits; rows computed in an M 6,272 call (the
    plan's 96-wide tiles) equal the same rows computed in an M 196 call
    (32-wide tiles), at each of the three products of DeiT-S."""
    for n, k, epi in ((384, 384, {"res": True}),
                      (1536, 384, {"bias": True, "gelu": True}),
                      (384, 1536, {"bias": True, "res": True})):
        a, w, bias, res = _wg_operands(card, 6272, n, k, seed=n * k)
        kw = {"bias": bias if epi.get("bias") else None,
              "res": res if epi.get("res") else None,
              "gelu": epi.get("gelu", False)}
        full = k_vita_layer.launch_wgmma_gemm(
            a, w, torch.empty((6272, n), device=card), **kw)
        again = k_vita_layer.launch_wgmma_gemm(
            a, w, torch.empty((6272, n), device=card), **kw)
        assert torch.equal(full, again)
        for r0 in (0, 3136, 6076):
            rows = slice(r0, r0 + 196)
            kw_rows = dict(kw, res=None if kw["res"] is None
                           else kw["res"][rows].contiguous())
            part = k_vita_layer.launch_wgmma_gemm(
                a[rows].contiguous(), w, torch.empty((196, n), device=card),
                **kw_rows)
            assert k_vita_layer.gemm_wgmma_plan(196, n, k).bn != \
                k_vita_layer.gemm_wgmma_plan(6272, n, k).bn
            assert torch.equal(part, full[rows])


@pytest.mark.parametrize("b", [1, 2])
def test_vita_layer_fp32_on_the_wgmma_route_matches_plain(card, b):
    """A DeiT-S-wide fp32 layer (D 384, 6 heads of 64, M 1,536, N 197):
    every product on the wgmma route (the counters say so), against the
    plain version at the fp32 bound of `test_vita_layer_float`."""
    bp, x = _wide_block(card, 197, 64, torch.float32, seed=5, h=6, b=b)
    bp["w_up"] = bp["w_up"].new_empty((384, 1536)).normal_() * 384 ** -0.5
    bp["b_up"] = 0.1 * torch.randn((1536,), device=card)
    bp["w_down"] = bp["w_down"].new_empty((1536, 384)).normal_() \
        * 1536 ** -0.5
    args = (x, *[bp[k] for k in _ORDER])
    trace.disable()
    trace.reset()
    trace.enable(cap=1_000)
    try:
        got = k_vita_layer.vita_layer(*args)
        torch.cuda.synchronize()
    finally:
        trace.disable()
    c = trace.counters()
    trace.reset()
    rows = b * 197
    macs = rows * 384 * 384 + 2 * rows * 384 * 1536
    assert c["kernels.gemm_macs"] == c["kernels.gemm_wgmma_macs"] == macs
    assert c["kernels.gemm_tile_macs"] >= macs
    want = ref.vita_layer_ref(*args)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def test_bf16_weights_keep_the_mma_sync_tile(card):
    """Kernel 1 with bf16 weights counts its products and none on the
    wgmma route."""
    bp, x = _wide_block(card, 197, 64, torch.bfloat16, seed=6, h=2, b=1)
    trace.disable()
    trace.reset()
    trace.enable(cap=1_000)
    try:
        k_vita_layer.vita_layer(x, *[bp[k] for k in _ORDER])
        torch.cuda.synchronize()
    finally:
        trace.disable()
    c = trace.counters()
    trace.reset()
    assert c["kernels.gemm_macs"] > 0
    assert c["kernels.gemm_wgmma_macs"] == c["kernels.gemm_tile_macs"] == 0
