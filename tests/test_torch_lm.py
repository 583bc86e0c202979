"""The port's LM path held against the JAX package on the CPU, at
`reduced()` of recurrentgemma-2b (the Griffin rec/rec/attn pattern, 26
layers of width 64), stablelm-3b (MHA, LayerNorm, gated SiLU),
qwen2.5-32b (`qkv_bias`), nemotron-4-15b (relu2, LayerNorm) and
h2o-danube-1.8b (sliding window): the
same JAX weights carried over by `convert.lm_params_from_numpy`, the same
numpy tokens, through `forward`, `prefill` (logits and caches) and
`decode_step`; the ring KV cache past the window; the slot server's
greedy tokens against the JAX `SlotServer`; the CLI; and the kinds and
modes the port does not run yet.

Tolerance: float32 on both sides, the same arithmetic in another order
(XLA's fused CPU matmuls and scan against torch's), so 2e-5 of the logit
scale (measured: at most 4e-6).
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
from repro.models import transformer as j_tr
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs as t_configs
from repro_torch import convert
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tr
from repro_torch.models.config import ModelConfig as TModelConfig

ARCHS = ["recurrentgemma-2b", "stablelm-3b", "qwen2.5-32b",
         "nemotron-4-15b", "h2o-danube-1.8b"]
REL = 2e-5


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * max(
        1.0, float(np.abs(want).max()))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX cfg, port cfg, JAX params, port params, tokens (2, 11))."""
    jc, tc = j_configs.get(arch).reduced(), t_configs.get(arch).reduced()
    jp = j_tr.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.lm_params_from_numpy(jp)
    toks = np.random.default_rng(0).integers(0, jc.vocab, size=(2, 11))
    return jc, tc, jp, tp, toks.astype(np.int32)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jc, tc, jp, tp, toks = _setup(arch)
    want = jax.jit(lambda p, t: j_tr.forward(p, {"tokens": t}, jc))(jp, toks)
    got = t_tr.forward(tp, {"tokens": _tt(toks)}, tc)
    _close(got.numpy(), want)
    _close(t_steps.make_forward_step(tc)(tp, {"tokens": _tt(toks)}), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch):
    jc, tc, jp, tp, toks = _setup(arch)
    cache_len = 16
    j_logits, j_caches = jax.jit(
        lambda p, t: j_tr.prefill(p, {"tokens": t}, jc, cache_len))(jp, toks)
    t_logits, t_caches = t_tr.prefill(tp, {"tokens": _tt(toks)}, tc,
                                      cache_len)
    _close(t_logits.numpy(), j_logits)
    for got, want in zip(t_caches, convert.lm_caches_from_numpy(j_caches)):
        assert got.keys() == want.keys()
        for key in got:
            _close(got[key].numpy(), want[key].numpy())
    pos = np.full((2,), toks.shape[1], np.int32)
    nxt = np.array([3, 7], np.int32)
    j_out, j_next = jax.jit(
        lambda p, t, c, q: j_tr.decode_step(p, t, c, q, jc))(
        jp, nxt, j_caches, pos)
    t_out, t_next = t_tr.decode_step(
        tp, _tt(nxt), convert.lm_caches_from_numpy(j_caches), _tt(pos), tc)
    _close(t_out.numpy(), j_out)
    for got, want in zip(t_next, convert.lm_caches_from_numpy(j_next)):
        for key in got:
            _close(got[key].numpy(), want[key].numpy())
    tok, _ = t_steps.make_prefill_step(tc, cache_len)(tp, {"tokens":
                                                           _tt(toks)})
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


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch,what", [
    ("xlstm-1.3b", "block kinds"), ("mixtral-8x7b", "MoE"),
    ("olmoe-1b-7b", "MoE"), ("hubert-xlarge", "input mode 'embeds'"),
    ("internvl2-26b", "input mode 'tokens\\+image'")])
def test_unported_kinds_and_modes_raise(arch, what):
    cfg = t_configs.get(arch).reduced()
    with pytest.raises(NotImplementedError, match=what):
        t_tr.init_params(cfg)
    with pytest.raises(NotImplementedError, match=what):
        t_tr.init_caches(cfg, 1, 8)
