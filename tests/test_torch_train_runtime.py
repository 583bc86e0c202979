"""The port's training runtime held against the JAX package on the CPU:
the data streams (`repro_torch.data`: `SyntheticLM` in all three input
modes, `ByteCorpus`, `SyntheticImages`, `shard_for_host`) bit-identical
to `repro.data`'s on the same seeds and steps, and the `Prefetcher`;
`CheckpointManager` (round trip with bf16 and int32 leaves, keep-n GC,
no partial commit, an empty latest, restore onto the like tree's devices
and dtypes, `elastic_resume`); the fault-tolerance pieces (watchdog,
`RetryingStep`, `PreemptionGuard`); and `launch.train.main --device cpu`,
whose kill-and-resume replays the uninterrupted run exactly, as the JAX
package's `test_train_resume_exact_replay`.
"""

import os
import signal

import numpy as np
import pytest
import torch

from repro.data import pipeline as j_data
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import pipeline as t_data
from repro_torch.distributed.ft import (PreemptionGuard, RetryingStep,
                                        StepWatchdog, elastic_resume)
from repro_torch.launch import train as t_train


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", ["tokens", "tokens+image", "embeds"])
def test_synthetic_lm_bit_identical_to_jax(mode):
    kw = dict(vocab=300, seq_len=24, batch=3, seed=7, n_image_tokens=5,
              d_model=16, input_mode=mode)
    j, t = j_data.SyntheticLM(**kw), t_data.SyntheticLM(**kw)
    for step in (0, 1, 5, 17):
        _equal_batches(t.batch_at(step), j.batch_at(step))
    again = t_data.SyntheticLM(**kw)          # a restart
    _equal_batches(again.batch_at(5), t.batch_at(5))
    it = iter(t)
    _equal_batches(next(it), j.batch_at(0))
    _equal_batches(next(it), j.batch_at(1))


def test_byte_corpus_and_images_bit_identical_to_jax():
    text = "hello world, the quick brown fox. " * 20
    for step in range(3):
        _equal_batches(t_data.ByteCorpus(text, 8, 2, seed=1).batch_at(step),
                       j_data.ByteCorpus(text, 8, 2, seed=1).batch_at(step))
        _equal_batches(
            t_data.SyntheticImages(16, 4, 5, seed=3).batch_at(step),
            j_data.SyntheticImages(16, 4, 5, seed=3).batch_at(step))


def test_shard_for_host_matches_jax():
    batch = t_data.SyntheticLM(100, 8, 8, seed=0).batch_at(2)
    for host in range(4):
        _equal_batches(t_data.shard_for_host(batch, host, 4),
                       j_data.shard_for_host(batch, host, 4))


def test_prefetcher_order_and_stop():
    pf = t_data.Prefetcher(iter([{"i": np.asarray(i)} for i in range(5)]),
                           depth=2)
    assert [int(b["i"]) for b in pf] == list(range(5))
    endless = t_data.Prefetcher(iter(t_data.SyntheticLM(50, 4, 2)), depth=2)
    assert next(endless)["tokens"].shape == (2, 4)
    endless.stop()


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "layers": [{"b": torch.linspace(-2, 2, 5).to(
                           torch.bfloat16)}]},
            "opt": {"m": torch.ones((3, 4)),
                    "count": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, process_index=0)
    tree = _tree()
    mgr.save(10, tree)
    out = mgr.restore(10, _zeros_like(tree))
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    b = out["params"]["layers"][0]["b"]
    assert b.dtype == torch.bfloat16 and torch.equal(
        b, tree["params"]["layers"][0]["b"])
    assert out["opt"]["count"].dtype == torch.int32
    assert int(out["opt"]["count"]) == 7


def test_checkpoint_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, process_index=0)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp dir left behind by a crash is never listed as a step."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3, process_index=0)
    mgr.save(5, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_0000000006.tmp"))
    assert mgr.all_steps() == [5]
    assert mgr.latest_step() == 5


def test_checkpoint_restore_latest_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3, process_index=0)
    step, out = mgr.restore_latest(_tree())
    assert step is None


def test_elastic_resume_onto_the_like_tree(tmp_path):
    """Restore into the like tree's dtypes and devices (here: a float64
    like for a float32 save, the CPU); the next step follows the saved
    one."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3, process_index=0)
    tree = _tree()
    mgr.save(3, tree)
    like = _zeros_like(tree)
    like["params"]["w"] = like["params"]["w"].double()
    step, out = elastic_resume(mgr, like)
    assert step == 4
    assert out["params"]["w"].dtype == torch.float64
    assert torch.equal(out["params"]["w"].float(), tree["params"]["w"])
    empty = CheckpointManager(str(tmp_path / "none"), process_index=0)
    assert elastic_resume(empty, like) == (0, like)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(deadline_s=0.0)
    wd.start()
    assert wd.check(0) is True
    assert wd.straggler_events == 1
    wd2 = StepWatchdog(deadline_s=60.0)
    wd2.start()
    assert wd2.check(0) is False


def test_retrying_step():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    r = RetryingStep(flaky, max_retries=5, backoff_s=0.0)
    assert r() == "ok"
    assert r.retry_events == 2
    with pytest.raises(RuntimeError, match="permanent"):
        RetryingStep(_always_fails, max_retries=1, backoff_s=0.0)()


def _always_fails():
    raise RuntimeError("permanent")


def test_preemption_guard_turns_sigterm_into_a_request():
    guard = PreemptionGuard(install=True)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.uninstall()
    assert not PreemptionGuard(install=False).requested


def test_train_resume_exact_replay(tmp_path):
    """Kill-and-resume reproduces the uninterrupted run exactly
    (stateless data, checkpointed optimizer state), on the CPU."""
    common = ["--arch", "stablelm-3b", "--reduced", "--batch", "2",
              "--seq", "16", "--log-every", "1", "--lr", "1e-3",
              "--device", "cpu"]
    h_full = t_train.main(common + ["--steps", "8"])
    ck = str(tmp_path / "ck")
    t_train.main(common + ["--steps", "4", "--ckpt-dir", ck,
                           "--ckpt-every", "100"])
    h_resumed = t_train.main(common + ["--steps", "8", "--ckpt-dir", ck,
                                       "--resume"])
    assert h_resumed[0]["step"] == 4
    assert h_full[-1]["step"] == h_resumed[-1]["step"] == 7
    assert abs(h_full[-1]["loss"] - h_resumed[-1]["loss"]) < 1e-4
    for a, b in zip(h_full[4:], h_resumed):
        assert a == b


def test_train_cli_compress_and_metrics_out(tmp_path):
    """--compress (int8 error feedback) trains an MoE config and writes
    --metrics-out; the loss of a few steps stays finite."""
    out = tmp_path / "m.json"
    hist = t_train.main(["--arch", "olmoe-1b-7b", "--reduced", "--batch",
                         "2", "--seq", "8", "--steps", "3", "--log-every",
                         "1", "--compress", "--device", "cpu",
                         "--metrics-out", str(out)])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and "moe_aux" in h for h in hist)
    assert out.exists()


def test_train_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--reduced", "--steps", "1"])
