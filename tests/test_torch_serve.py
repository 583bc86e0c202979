"""The port's VisionServer on the CPU (``device="cpu"``) held against the
JAX server: padding to buckets, dispatch/complete, run stats, and the
logits for the same images and weights in float and int8 (tolerances as
in tests/test_torch_model.py)."""

import functools

import numpy as np
import pytest
import torch

from repro.launch import vision_serve as j_serve
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve

BUCKETS = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def _jax_run(mode: str):
    """The JAX server's logits for 5 images (4 + a ragged 1), and its
    params / int8 params / frozen scales."""
    server = j_serve.make_server(
        "deit_t", j_serve.ServeConfig(mode=mode, buckets=BUCKETS,
                                      calib_images=4))
    images = np.random.default_rng(3).standard_normal(
        (5, 64, 64, 3)).astype(np.float32)
    reqs = server.submit_many(images)
    server.run()
    scales = server.calibrator.frozen if mode == "int8" else None
    return (np.stack([r.logits for r in reqs]), images, server.params,
            server.qparams, scales)


def _port_server(mode: str):
    _, _, params, qparams, scales = _jax_run(mode)
    return t_serve.make_server(
        "deit_t", t_serve.ServeConfig(mode=mode, buckets=BUCKETS,
                                      device="cpu"),
        params=params_from_numpy(params),
        qparams=None if qparams is None else params_from_numpy(qparams),
        calibrator=None if scales is None else calibrator_from_scales(scales))


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_server_matches_jax_server(mode):
    want, images, *_ = _jax_run(mode)
    server = _port_server(mode)
    reqs = server.submit_many(images)
    stats = server.run()
    got = np.stack([r.logits for r in reqs])
    assert got.shape == want.shape == (5, 10)
    assert stats["requests"] == 5 and stats["batches"] == 2
    assert stats["padded"] == 0 and stats["device"] == "cpu"
    if mode == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    assert [r.pred for r in reqs] == list(got.argmax(1))


def test_dispatch_complete_pads_to_bucket():
    server = _port_server("float")
    images = np.random.default_rng(4).standard_normal(
        (3, 64, 64, 3)).astype(np.float32)
    server.submit_many(images)
    inflight = server.dispatch()
    assert inflight.bucket == 4 and len(inflight.requests) == 3
    assert inflight.event is None                  # CPU: already complete
    assert server.n_padded == 1
    assert server.complete(inflight) == 3
    assert server.dispatch() is None and server.complete(None) == 0
    alone = server.forward(torch.from_numpy(images[:1]))
    np.testing.assert_allclose(server.done[0].logits, alone[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        server.dispatch(server.submit_many(images), bucket=2)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_ring_of_depth_matches_run(depth):
    """``depth`` micro-batches dispatched before any completes, then
    completed in order, give every request the logits `run` gives the
    same images, and keep them after the rest complete."""
    images = np.random.default_rng(5).standard_normal(
        (4 * depth - 1, 64, 64, 3)).astype(np.float32)
    twin = _port_server("float")
    want = twin.submit_many(images)
    twin.run()
    server = _port_server("float")
    got = server.submit_many(images)
    ring = [server.dispatch() for _ in range(depth)]
    assert [f.bucket for f in ring] == [4] * depth
    assert all(f.copied is None for f in ring)
    first = []
    for inflight in ring:
        assert server.complete(inflight) == len(inflight.requests)
        first.append(np.stack([r.logits for r in inflight.requests]))
    g = np.stack([r.logits for r in got])
    np.testing.assert_array_equal(g, np.stack([r.logits for r in want]))
    np.testing.assert_array_equal(g, np.concatenate(first))


def test_make_server_int8_calibrates_on_the_cpu():
    server = t_serve.make_server("vit_edge", t_serve.ServeConfig(
        mode="int8", buckets=(2,), calib_images=4, device="cpu"))
    assert server.calibrator.frozen["l0.qkv_in"].device.type == "cpu"
    server.submit_many(np.zeros((3, 32, 32, 3), np.float32))
    stats = server.run()
    assert stats["requests"] == 3 and stats["padded"] == 1


def test_serve_config_validates():
    with pytest.raises(ValueError):
        t_serve.ServeConfig(mode="fp16")
    with pytest.raises(ValueError):
        t_serve.ServeConfig(buckets=(0, 2))
    assert t_serve.ServeConfig(buckets=(4, 1, 4)).buckets == (1, 4)
    with pytest.raises(ValueError):
        t_serve.VisionServer(None, None, serve_cfg=t_serve.ServeConfig(
            mode="int8", device="cpu"))


def test_default_device_is_the_card():
    """Without a device the server asks for the card; with no card that
    is an error, not a silent CPU run."""
    if torch.cuda.is_available():
        assert t_serve.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.make_server("vit_edge", t_serve.ServeConfig())


def test_cli_serves_both_modes_on_the_cpu(capsys):
    rows = t_cli.main(["--vision", "--model", "vit_edge", "--requests", "3",
                       "--buckets", "1,2", "--device", "cpu"])
    assert [r["mode"] for r in rows] == ["float", "int8"]
    assert all(r["requests"] == 3 and r["batches"] == 2 for r in rows)
    assert "vit_edge_32 mode=int8 on cpu" in capsys.readouterr().out
    assert t_cli.main(["--vision", "--list-models"]) == []
    with pytest.raises(SystemExit):
        t_cli.main(["--model", "vit_edge"])


def test_service_time_spans_the_forward():
    """``t_start`` is stamped before the forward is issued, as the JAX
    server stamps it at its asynchronous call, so a drain's p50 service
    time covers most of its wall time per micro-batch (stamped after the
    eager forward it held only the tail: about 0.04 ms of 89)."""
    server = t_serve.make_server("deit_t", t_serve.ServeConfig(
        buckets=(8,), device="cpu"))
    server.submit_many(np.random.default_rng(5).standard_normal(
        (32, 64, 64, 3)).astype(np.float32))
    stats = server.run()
    assert stats["batches"] == 4
    per_batch_ms = 1e3 * stats["wall_s"] / stats["batches"]
    assert stats["service_p50_ms"] >= 0.5 * per_batch_ms, (
        stats["service_p50_ms"], per_batch_ms)
    assert stats["device_p50_ms"] is None         # no CUDA events here
