"""The port's VisionServer on meshes of gloo CPU ranks: drains on a data
mesh (the padding path) and on a model mesh (a ragged tail) against the
single-device server and the JAX server, the batch-1 bucket of a model
mesh, bucket rounding to the data axis, the CLI's --devices, --mesh and
--latency-mesh, the open stream's latency-mesh routing, and a failing
rank failing its command instead of hanging it.

One pool of four ranks serves the whole module."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.launch import vision_serve as j_serve
from repro_torch.launch import admission as t_adm
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import vision_serve as t_serve
from repro_torch.models import vision_registry as t_vr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    world = t_mesh.start_world(4, "cpu", timeout_s=120)
    yield world
    world.close()


@functools.lru_cache(maxsize=None)
def _weights(mode: str):
    """vit_edge's port params (seed 0) and, for int8, its int8 params and
    frozen scales calibrated on the CPU."""
    cfg = t_vr.build_cfg("vit_edge")
    params = t_vr.init_params(cfg, 0)
    if mode == "float":
        return cfg, params, None, None
    qparams = t_vr.quantize(params)
    bank = np.random.default_rng(9).standard_normal(
        (4, cfg.image, cfg.image, 3)).astype(np.float32)
    return (cfg, params, qparams,
            t_serve.calibrate(qparams, cfg, bank, device="cpu", n_batches=1))


def _images(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, 32, 32, 3)).astype(np.float32)


def _server(mode: str, **kw):
    cfg, params, qparams, cal = _weights(mode)
    return t_serve.VisionServer(
        cfg, params, qparams=qparams, calibrator=cal,
        serve_cfg=t_serve.ServeConfig(mode=mode, device="cpu", **kw))


def _drain(server, images):
    reqs = server.submit_many(images)
    stats = server.run()
    return np.stack([r.logits for r in reqs]), stats


@functools.lru_cache(maxsize=None)
def _jax_logits(n: int):
    """The JAX server's float logits for ``n`` images on the same
    weights."""
    cfg, params, _, _ = _weights("float")
    j_params = _numpy_tree(params)
    server = j_serve.VisionServer(
        j_serve.build_edge_vit(image=32, patch=8, dim=96, heads=4,
                               layers=4, backend="xla"),
        j_params, serve_cfg=j_serve.ServeConfig(buckets=(1, 2, 4, 8)))
    reqs = server.submit_many(_images(n))
    server.run()
    return np.stack([r.logits for r in reqs])


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


@pytest.mark.parametrize("mode", ["float", "int8"])
@pytest.mark.parametrize("shape,n,batches,padded", [
    ("2x1", 5, 1, 3),          # buckets (2, 4, 8): all 5 pad to 8
    ("1x2", 11, 2, 1),         # 8, then a ragged 3 padded to 4
])
def test_mesh_drain_matches_single_device(pool, shape, n, batches, padded,
                                          mode):
    images = _images(n)
    solo, _ = _drain(_server(mode), images)
    server = _server(mode, mesh_shape=shape)
    got, stats = _drain(server, images)
    d, m = t_mesh.parse_mesh_shape(shape)
    assert (server.dp, server.mp, server.n_devices) == (d, m, d * m)
    assert stats["mesh_shape"] == shape and stats["devices"] == d * m
    assert (stats["requests"], stats["batches"], stats["padded"]) == \
        (n, batches, padded)
    assert stats["device_p50_ms"] is None           # no events on a mesh
    scale = np.abs(solo).max()
    if mode == "float":
        assert np.abs(got - solo).max() <= 1e-5 * scale
        want = _jax_logits(n)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.argmax(1), solo.argmax(1))
        assert np.abs(got - solo).max() <= 0.02 * scale


def test_buckets_round_to_the_data_axis(pool):
    """On a (2, 2) mesh the buckets round to the data axis's 2, not the 4
    ranks; a data-only mesh lifts bucket 1, a model mesh keeps it (the
    batch-1 latency path: the image replicates over data, the heads
    split)."""
    assert _server("float", buckets=(2, 4, 8), mesh_shape="2x2"
                   ).buckets == (2, 4, 8)
    assert _server("float", buckets=(1, 2, 4), data_parallel=2
                   ).buckets == (2, 4)
    server = _server("float", buckets=(1, 4), mesh_shape="2x2")
    assert (server.dp, server.mp, server.mesh_shape) == (2, 2, "2x2")
    assert server.buckets == (1, 2, 4)         # 1 kept, 1 lifted to 2
    got, stats = _drain(server, _images(1, seed=4))
    assert (stats["batches"], stats["padded"]) == (1, 0)
    solo, _ = _drain(_server("float", buckets=(1,)), _images(1, seed=4))
    assert np.abs(got - solo).max() <= 1e-5 * np.abs(solo).max()
    one = _server("float")
    assert (one.mesh, one.mesh_shape, one.n_devices) == (None, "1x1", 1)


@pytest.mark.parametrize("flags,shape", [
    (["--devices", "2"], "2x1"),
    (["--mesh", "1x2"], "1x2"),
    (["--mesh", "2x2", "--devices", "3"], "2x2"),
])
def test_cli_mesh_roundtrip(pool, flags, shape):
    rows = t_serve.main(["--model", "vit_edge", "--device", "cpu",
                         "--requests", "4", "--mode", "both",
                         "--buckets", "2,4", *flags])
    assert [r["mode"] for r in rows] == ["float", "int8"]
    assert all(r["mesh_shape"] == shape and r["requests"] == 4
               for r in rows)


def test_cli_latency_mesh_roundtrip(pool):
    rows = t_serve.main(["--model", "vit_edge", "--device", "cpu",
                         "--arrival-rate", "50", "--requests", "4",
                         "--mode", "float", "--buckets", "1,2",
                         "--latency-mesh", "1x2"])
    assert rows[0]["latency_mesh"] == "1x2" and rows[0]["requests"] == 4
    with pytest.raises(SystemExit):
        t_serve.main(["--model", "vit_edge", "--device", "cpu",
                      "--latency-mesh", "1x2"])
    with pytest.raises(SystemExit):
        t_serve.main(["--model", "vit_edge", "--device", "cpu",
                      "--mesh", "2x0"])


def test_stream_routes_tight_singles_to_the_latency_mesh(pool):
    """A budget no throughput bucket meets (a bench record says each takes
    a second; the budget is 500 ms): singles route to the batch-1 server
    on the "1x2" mesh, and every arrival is served."""
    trace = t_adm.poisson_trace(40.0, 8, "vit_edge", sla_ms=500.0, seed=0)
    slow = {"runs": [{"model": "vit_edge", "mode": "float", "fused": True,
                      "mesh_shape": "1x1", "batch": b, "wall_s": 2.0,
                      "batches": 2} for b in (1, 2, 4)]}
    (row,) = t_serve.serve_stream(["vit_edge"], modes=("float",),
                                  buckets=(1, 2, 4), trace=trace,
                                  latency_mesh="1x2", bench_data=slow,
                                  device="cpu")
    assert row["requests"] == row["offered"] == 8
    assert row["routed_latency_path"] > 0
    assert (row["mesh_shape"], row["latency_mesh"]) == ("1x1", "1x2")


def test_backend_follows_ranks_and_cards(monkeypatch):
    """NCCL only where every rank gets a card of its own; gloo where ranks
    would share one, and on the CPU (chosen before any group exists)."""
    monkeypatch.setattr(t_mesh.torch.cuda, "device_count", lambda: 4)
    assert t_mesh.choose_backend(4, "cuda") == "nccl"
    assert t_mesh.choose_backend(3, None) == "nccl"
    assert t_mesh.choose_backend(5, "cuda") == "gloo"
    assert t_mesh.choose_backend(2, "cpu") == "gloo"
    assert [str(t_mesh.rank_device(r, "cuda")) for r in (0, 3, 5)] == \
        ["cuda:0", "cuda:3", "cuda:1"]
    assert t_mesh.rank_device(2, "cpu") == t_mesh.torch.device("cpu")


def test_failed_rank_fails_the_command():
    """A rank that raises inside a command: rank 0's collective fails
    within seconds instead of hanging, and closing the world reports
    it (a fresh process: the failure ends its world)."""
    code = ("import sys; sys.path[:0] = ['src', 'tests']\n"
            "from repro_torch.launch import mesh\n"
            "from _torch_mesh_ranks import fail_on\n"
            "w = mesh.start_world(2, 'cpu', timeout_s=60)\n"
            "m = mesh.make_vision_mesh(1, 2, 'cpu')\n"
            "try:\n"
            "    m.call(fail_on, m, 1)\n"
            "except Exception as e:\n"
            "    print('command failed:', type(e).__name__)\n"
            "try:\n"
            "    w.close()\n"
            "except RuntimeError as e:\n"
            "    print('close raised:', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "command failed:" in proc.stdout
    assert "close raised:" in proc.stdout
