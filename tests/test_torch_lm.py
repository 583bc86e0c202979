"""The port's LM path held against the JAX package on the CPU, at
`reduced()` of all ten registered configs: recurrentgemma-2b (the Griffin
rec/rec/attn pattern), stablelm-3b (MHA, LayerNorm, gated SiLU),
qwen2.5-32b (`qkv_bias`), nemotron-4-15b (relu2, LayerNorm),
h2o-danube-1.8b (sliding window), olmoe-1b-7b and mixtral-8x7b (the MoE
feed-forward, 8 experts of 32, top 2, capacity 4.0), xlstm-1.3b (sLSTM
then 7 mLSTM blocks, two superblocks), hubert-xlarge (the ``embeds``
input mode, non-causal, no decode) and internvl2-26b (``tokens+image``:
8 patch embeddings ahead of the text).  The same JAX weights carried over
by `convert.lm_params_from_numpy`, the same numpy inputs, through
`forward`, `prefill` (logits and caches) and `decode_step`; the ring KV
cache past the window; the slot server's greedy tokens against the JAX
`SlotServer` for every token-input decoder; the CLI; and the configs the
slot server refuses.

Tolerance: float32 on both sides, the same arithmetic in another order
(XLA's fused CPU matmuls and scan against torch's), so 2e-5 of the logit
scale (measured: at most 4e-6), block by block for xLSTM too.  xLSTM's
whole model is held at 5e-4 instead: its mLSTM blocks amplify float32
rounding one after another, in either package (a float64 evaluation of
the same weights lies as far from each), so the 16 blocks together land
about 1e-4 of the logit scale apart while each alone agrees at 2e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.launch import steps as j_steps
from repro.models import transformer as j_tr
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tr
from repro_torch.models.config import ModelConfig as TModelConfig

ARCHS = t_configs.list_archs()
DECODERS = [a for a in ARCHS if t_configs.get(a).supports_decode]
TOKEN_DECODERS = [a for a in DECODERS
                  if t_configs.get(a).input_mode == "tokens"]
REL = 2e-5
REL_XLSTM = 5e-4


def _rel(arch):
    return REL_XLSTM if arch == "xlstm-1.3b" else REL


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(
        1.0, float(np.abs(want).max()))


def _inputs(cfg, b, t, seed):
    """Numpy inputs of ``cfg``'s input mode: tokens (b, t) int32, and
    patch embeddings (b, n_image_tokens, D) or frames (b, t, D)
    float32."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": rng.standard_normal(
            (b, t, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, size=(b, t)).astype(
        np.int32)}
    if cfg.input_mode == "tokens+image":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX cfg, port cfg, JAX params, port params, numpy batch of 2
    sequences of 11 tokens or frames)."""
    jc, tc = j_configs.get(arch).reduced(), t_configs.get(arch).reduced()
    jp = j_tr.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.lm_params_from_numpy(jp)
    return jc, tc, jp, tp, _inputs(jc, 2, 11, 0)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _tt(a):
    return torch.from_numpy(np.array(a))


def test_configs_match_the_jax_registry():
    assert t_configs.list_archs() == j_configs.list_archs()
    for arch in t_configs.list_archs():
        j, t = j_configs.get(arch), t_configs.get(arch)
        for cfg_j, cfg_t in ((j, t), (j.reduced(), t.reduced())):
            fj = {f.name: getattr(cfg_j, f.name)
                  for f in dataclasses.fields(cfg_j)}
            ft = {f.name: getattr(cfg_t, f.name)
                  for f in dataclasses.fields(cfg_t)}
            fj["moe"] = None if fj["moe"] is None else dataclasses.astuple(
                fj["moe"])
            ft["moe"] = None if ft["moe"] is None else dataclasses.astuple(
                ft["moe"])
            assert fj == ft
            assert (cfg_j.hd, cfg_j.padded_vocab, cfg_j.n_superblocks,
                    cfg_j.kv_cache_len(4096)) == (
                cfg_t.hd, cfg_t.padded_vocab, cfg_t.n_superblocks,
                cfg_t.kv_cache_len(4096))
        for shape in t_configs.SHAPES:
            assert t_configs.cell_supported(t, shape) == \
                j_configs.cell_supported(j, shape)
    assert t_configs.get("recurrentgemma-2b").param_dtype == torch.bfloat16


def test_converted_layers_are_in_layer_order():
    jc, tc, jp, tp, _ = _setup("recurrentgemma-2b")
    kinds = t_tr.layer_kinds(tc)
    assert len(tp["layers"]) == len(kinds) == jc.n_layers
    p = len(jc.pattern)
    for i, kind in enumerate(kinds):
        want = np.asarray(jp["layers"][i % p]["norm1"]["w"][i // p])
        assert np.array_equal(tp["layers"][i]["norm1"]["w"].numpy(), want)
        assert ("wq" in tp["layers"][i]["mixer"]) == (kind == "attn")
    # bf16 leaves (a config's own dtype) keep their bits.
    leaf = jnp.asarray(np.linspace(-3, 3, 7), jnp.bfloat16)
    got = convert.params_from_numpy({"w": leaf})["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.from_numpy(
        np.asarray(leaf.astype(jnp.float32))))


def test_converted_xlstm_and_moe_trees():
    """xLSTM's pattern (sLSTM, then 7 mLSTM) unstacks as layer i = pattern
    position i % 8 of superblock i // 8, with its block-diagonal weights,
    float32 recurrence and biases; the MoE stacks keep (E, D, F) per layer
    and a float32 router; the caches unstack the same way."""
    jc, tc, jp, tp, _ = _setup("xlstm-1.3b")
    kinds = t_tr.layer_kinds(tc)
    assert kinds == ["slstm"] + ["mlstm"] * 7 + ["slstm"] + ["mlstm"] * 7
    h, dh = tc.n_heads, 2 * tc.d_model // tc.n_heads
    for i, kind in enumerate(kinds):
        src = jp["layers"][i % 8]["mixer"]
        got = tp["layers"][i]["mixer"]
        assert got.keys() == src.keys()
        for key in got:
            assert np.array_equal(got[key].numpy(),
                                  np.asarray(src[key][i // 8]))
        if kind == "mlstm":
            assert got["w_q"].shape == (h, dh, dh)
            assert got["b_if"].dtype == torch.float32
        else:
            assert got["r"].shape == (4, h, tc.d_model // h, tc.d_model // h)
            assert got["r"].dtype == got["b_in"].dtype == torch.float32
    caches = convert.lm_caches_from_numpy(j_tr.init_caches(jc, 3, 8))
    assert [sorted(c) for c in caches] == [
        ["c", "h", "m", "n"] if k == "slstm" else ["C", "m", "n"]
        for k in kinds]
    assert caches[1]["C"].shape == (3, h, dh, dh)
    assert float(caches[0]["m"][0, 0]) == float(np.float32(-1e30))
    for arch in ("olmoe-1b-7b", "mixtral-8x7b"):
        jc, tc, jp, tp, _ = _setup(arch)
        e, d, f = tc.moe.n_experts, tc.d_model, tc.moe.d_ff
        for layer in tp["layers"]:
            moe = layer["moe"]
            assert "mlp" not in layer and moe["router"].dtype == torch.float32
            assert (moe["router"].shape, moe["w_up"].shape,
                    moe["w_gate"].shape, moe["w_down"].shape) == (
                (d, e), (e, d, f), (e, d, f), (e, f, d))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jc, tc, jp, tp, batch = _setup(arch)
    want = jax.jit(lambda p, b: j_tr.forward(p, b, jc))(jp, _jb(batch))
    got = t_tr.forward(tp, _tb(batch), tc)
    _close(got.numpy(), want, _rel(arch))
    _close(t_steps.make_forward_step(tc)(tp, _tb(batch)), want, _rel(arch))


def test_xlstm_blocks_match_jax_block_by_block():
    """Each xLSTM block (forward, prefill and its cache) on the same input
    as the JAX block, at the float32 bound: the assembly's wiring, free of
    the model's amplification."""
    jc, tc, jp, tp, batch = _setup("xlstm-1.3b")
    x = j_tr.embed_batch(jp, _jb(batch), jc)
    for i, kind in enumerate(t_tr.layer_kinds(tc)):
        jl = jax.tree_util.tree_map(lambda a: a[i // 8],
                                    jp["layers"][i % 8])
        want = j_tr._block_forward(kind, jl, x, jc)
        got = t_tr._block_forward(kind, tp["layers"][i], _tt(x), tc)
        _close(got.numpy(), want)
        want_p, want_c = j_tr._block_prefill(kind, jl, x, jc, 16)
        got_p, got_c = t_tr._block_prefill(kind, tp["layers"][i], _tt(x),
                                           tc, 16)
        _close(got_p.numpy(), want_p)
        for key in got_c:
            _close(got_c[key].numpy(), want_c[key])
        x = want


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_step_match_jax(arch):
    jc, tc, jp, tp, batch = _setup(arch)
    cache_len = 16 + jc.n_image_tokens
    rel = _rel(arch)
    j_logits, j_caches = jax.jit(
        lambda p, b: j_tr.prefill(p, b, jc, cache_len))(jp, _jb(batch))
    t_logits, t_caches = t_tr.prefill(tp, _tb(batch), tc, cache_len)
    _close(t_logits.numpy(), j_logits, rel)
    for got, want in zip(t_caches, convert.lm_caches_from_numpy(j_caches)):
        assert got.keys() == want.keys()
        for key in got:
            _close(got[key].numpy(), want[key].numpy(), rel)
    pos = np.full((2,), t_steps.next_position(tc, _tb(batch)), np.int32)
    nxt = np.array([3, 7], np.int32)
    j_out, j_next = jax.jit(
        lambda p, t, c, q: j_tr.decode_step(p, t, c, q, jc))(
        jp, nxt, j_caches, pos)
    t_out, t_next = t_tr.decode_step(
        tp, _tt(nxt), convert.lm_caches_from_numpy(j_caches), _tt(pos), tc)
    _close(t_out.numpy(), j_out, rel)
    for got, want in zip(t_next, convert.lm_caches_from_numpy(j_next)):
        for key in got:
            _close(got[key].numpy(), want[key].numpy(), rel)
    tok, _ = t_steps.make_prefill_step(tc, cache_len)(tp, _tb(batch))
    assert tok.tolist() == np.argmax(
        np.asarray(j_logits)[:, 0, :jc.vocab], -1).tolist()


def test_swa_ring_cache_equivalence():
    """Decoding past the window (the JAX package's test of the same name,
    on the port, with the same JAX weights): ring-cache decode == forward
    over the whole sequence, and == the JAX decode."""
    kw = dict(name="swa", family="dense", n_layers=2, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab=64, window=6, dtype="float32",
              vocab_pad_multiple=16)
    jc, tc = JModelConfig(**kw), TModelConfig(**kw)
    jp = j_tr.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.lm_params_from_numpy(jp)
    b, s = 1, 20
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                                         64)).astype(np.int32)
    # 10 prompt tokens > window 6: the prefill cache is the rolled ring.
    _, caches = t_tr.prefill(tp, {"tokens": _tt(toks[:, :10])}, tc,
                             cache_len=s)
    assert caches[0]["k"].shape[2] == 6
    _, j_caches = j_tr.prefill(jp, {"tokens": jnp.asarray(toks[:, :10])},
                               jc, cache_len=s)
    lg = j_lg = None
    for t in range(10, s):
        lg, caches = t_tr.decode_step(tp, _tt(toks[:, t]), caches,
                                      torch.full((b,), t), tc)
        j_lg, j_caches = j_tr.decode_step(jp, jnp.asarray(toks[:, t]),
                                          j_caches, jnp.full((b,), t), jc)
    full = t_tr.forward(tp, {"tokens": _tt(toks)}, tc)
    np.testing.assert_allclose(lg.numpy(), full[:, -1].numpy(), rtol=1e-4,
                               atol=1e-4)
    _close(lg.numpy(), j_lg)


def _jax_drain(cfg, params, queue, batch, cache_len):
    """The JAX server's main loop (`repro.launch.serve.main`) over
    ``queue``."""
    server = j_serve.SlotServer(cfg, params, batch, cache_len)
    pending, done = list(queue), []
    while pending or any(server.active):
        for slot in range(server.b):
            if server.active[slot] is None and pending:
                server._prefill_one(slot, pending.pop(0))
        server.step()
        for slot, req in enumerate(server.active):
            if req and len(req.generated) >= req.max_new:
                done.append(req)
                server.active[slot] = None
    return done


@pytest.mark.parametrize("arch", TOKEN_DECODERS)
def test_slot_server_greedy_tokens_match_jax(arch):
    """Three requests over two slots (one waits for a slot), prompts of
    4-6 tokens, 5 new tokens each: the same greedy tokens, and the port's
    kept logits are its decode steps' own."""
    jc, tc, jp, tp, _ = _setup(arch)
    j_queue = [j_serve.Request(r.rid, r.prompt, r.max_new)
               for r in t_serve.make_requests(tc, 3, 6, 5, seed=1)]
    t_queue = t_serve.make_requests(tc, 3, 6, 5, seed=1)
    want = {r.rid: r.generated for r in _jax_drain(jc, jp, j_queue, 2, 32)}
    server = t_serve.SlotServer(tc, tp, 2, 32, keep_logits=True)
    done = t_serve.drain(server, t_queue)
    assert {r.rid: r.generated for r in done} == want
    for r in done:
        assert len(r.logits) == len(r.generated) == 5
        assert [int(np.argmax(lg)) for lg in r.logits] == r.generated


def test_cli_serves_reduced_on_the_cpu(capsys):
    stats = t_serve.main(["--arch", "recurrentgemma-2b", "--reduced",
                          "--device", "cpu", "--requests", "2", "--batch",
                          "2", "--max-new", "4", "--cache-len", "32"])
    assert stats["requests"] == 2 and stats["tokens"] == 8
    assert all(len(g) == 4 for g in stats["generated"])
    assert "recurrentgemma-2b reduced=True on cpu" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_serve.main(["--reduced", "--requests", "1"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-1.3b"])
def test_cli_serves_moe_and_xlstm_reduced_on_the_cpu(arch, capsys):
    stats = t_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--batch", "2", "--max-new",
                          "3", "--cache-len", "32"])
    assert stats["requests"] == 3 and stats["tokens"] == 9
    assert f"{arch} reduced=True on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch,error", [
    ("hubert-xlarge", "encoder-only"),
    ("internvl2-26b", "tokens only, not the 'tokens\\+image'")])
def test_slot_server_refuses_what_jax_cannot_serve(arch, error):
    """The JAX server asserts `supports_decode` and feeds tokens only: the
    port raises a clear error for both (and its CLI exits)."""
    _, tc, _, tp, _ = _setup(arch)
    with pytest.raises(ValueError, match=error):
        t_serve.SlotServer(tc, tp, 2, 32)
    with pytest.raises(SystemExit, match=error.split(",")[0]):
        t_serve.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_hubert_forward_is_frame_permutation_equivariant():
    """The JAX package's invariant (`test_encoder_is_order_sensitive_via_
    frontend`) on the port: the non-causal encoder without RoPE permutes
    its output with its frames; and the permuted run equals JAX's."""
    jc, tc, jp, tp, _ = _setup("hubert-xlarge")
    emb = np.random.default_rng(1).standard_normal(
        (1, 8, tc.d_model)).astype(np.float32)
    perm = [3, 1, 2, 0, 5, 4, 7, 6]
    out1 = t_tr.forward(tp, {"embeds": _tt(emb)}, tc)
    out2 = t_tr.forward(tp, {"embeds": _tt(emb[:, perm])}, tc)
    np.testing.assert_allclose(out2.numpy(), out1[:, perm].numpy(),
                               rtol=2e-5, atol=2e-5)
    _close(out2.numpy(), j_tr.forward(jp, {"embeds": jnp.asarray(
        emb[:, perm])}, jc))


def test_embeds_with_an_input_projection_match_jax():
    """``embeds`` frames of another width than d_model go through
    ``in_proj`` (and there is no ``embed``), as in the JAX package; the
    ``embeds`` decode step takes the rows themselves."""
    kw = dict(name="enc", family="audio", n_layers=2, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=64, vocab=40, input_mode="embeds",
              embed_dim_in=24, causal=True, dtype="float32",
              vocab_pad_multiple=16)
    jc, tc = JModelConfig(**kw), TModelConfig(**kw)
    jp = j_tr.init_params(jax.random.PRNGKey(2), jc)
    tp = convert.lm_params_from_numpy(jp)
    assert "embed" not in tp and tp["in_proj"].shape == (24, 32)
    assert sorted(t_tr.init_params(tc)) == sorted(tp)
    emb = np.random.default_rng(2).standard_normal((2, 7, 24)).astype(
        np.float32)
    _close(t_tr.forward(tp, {"embeds": _tt(emb)}, tc).numpy(),
           j_tr.forward(jp, {"embeds": jnp.asarray(emb)}, jc))
    _, j_caches = j_tr.prefill(jp, {"embeds": jnp.asarray(emb)}, jc, 16)
    row = np.random.default_rng(3).standard_normal((2, 32)).astype(
        np.float32)
    pos = np.full((2,), 7, np.int32)
    j_out, _ = j_tr.decode_step(jp, jnp.asarray(row), j_caches,
                                jnp.asarray(pos), jc)
    t_out, _ = t_tr.decode_step(tp, _tt(row),
                                convert.lm_caches_from_numpy(j_caches),
                                _tt(pos), tc)
    _close(t_out.numpy(), j_out)


def test_internvl2_prefill_with_patch_embeds_then_decode_match_jax():
    """``tokens+image``: the prefill step's greedy token and 4 decode
    steps fed it (positions from n_image_tokens + the prompt's length,
    the cache covering the image) against JAX's steps; and the last
    decode logits against the port's `forward` over image + every
    token."""
    jc, tc, jp, tp, _ = _setup("internvl2-26b")
    batch = _inputs(jc, 2, 6, 4)
    cache_len = 24
    j_prefill = jax.jit(j_steps.make_prefill_step(jc, cache_len))
    j_decode = jax.jit(j_steps.make_decode_step(jc))
    j_tok, j_caches = j_prefill(jp, _jb(batch))
    t_tok, t_caches, _ = t_steps.make_prefill_step(
        tc, cache_len, with_logits=True)(tp, _tb(batch))
    decode = t_steps.make_decode_step(tc, with_logits=True)
    pos = t_steps.next_position(tc, _tb(batch))
    assert pos == jc.n_image_tokens + 6
    toks = [t_tok]
    for step in range(4):
        assert t_tok.tolist() == np.asarray(j_tok).tolist()
        q = np.full((2,), pos + step, np.int32)
        j_tok, j_caches = j_decode(jp, j_tok, j_caches, q)
        t_tok, t_caches, t_logits = decode(tp, t_tok, t_caches, _tt(q))
        toks.append(t_tok)
    assert t_tok.tolist() == np.asarray(j_tok).tolist()
    full = dict(_tb(batch), tokens=torch.cat(
        [_tt(batch["tokens"])] + [t[:, None] for t in toks[:-1]], dim=1))
    _close(t_logits.numpy(), t_tr.forward(tp, full, tc)[:, -1].numpy())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b",
                                  "xlstm-1.3b"])
def test_decode_equals_forward_over_the_whole_sequence(arch):
    """Prefill then 5 greedy decode steps: each step's logits equal the
    port's `forward` over the prompt and the tokens before it (MoE at a
    dropless capacity, n_experts / top_k, where forward and the dropless
    decode route alike; xLSTM's recurrent prefill and decode against its
    parallel forward) -- the check the card runs on each decoder."""
    _, tc, _, tp, _ = _setup(arch)
    if tc.moe is not None:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, capacity_factor=tc.moe.n_experts / tc.moe.top_k))
    toks = _tt(_inputs(tc, 1, 7, 5)["tokens"])
    tok, caches, _ = t_steps.make_prefill_step(tc, 16, with_logits=True)(
        tp, {"tokens": toks})
    decode = t_steps.make_decode_step(tc, with_logits=True)
    seq = [toks, tok[:, None]]
    for step in range(5):
        tok, caches, logits = decode(tp, tok, caches,
                                     torch.tensor([7 + step]))
        want = t_tr.forward(tp, {"tokens": torch.cat(seq, dim=1)}, tc)
        _close(logits.numpy(), want[:, -1].numpy(), _rel(arch))
        seq.append(tok[:, None])
