"""The port's open-stream serving (`repro_torch.launch.admission`, the
serving hooks of `repro_torch.launch.vision_serve`) held against the JAX
package on the CPU.

* `select_bucket` equals JAX's on drawn tables and budgets, and keeps the
  contract tests/test_admission.py holds (feasible, largest feasible,
  smallest on degradation, monotone in the budget).
* `poisson_trace`, `load_trace`, `latency_table_from_bench` and
  `stream_summary` return equal values on equal inputs (exactly: they are
  the same arithmetic).
* Scheduling parity: a JAX controller and a port controller get the same
  submits (same ``t_submit`` and ``sla_ms``), the same fixed latency
  tables and the same ``now`` in every `step`; the sequence of dispatches
  (lane, request ids, bucket, path) and the counters
  (``infeasible_served``, ``held_partials``, ``routed_latency_path``) must
  be identical.
* Logits through `run_open_stream` equal the JAX server's for the same
  bank image on the same weights: within 1e-5 in float (fp32
  reassociation at a tiny width); in int8 on the same frozen scales with
  equal argmax and within 2% of the logit scale (single-LSB requant
  flips), tests/test_torch_serve.py's bound.
* The run row's schema holds JAX's keys, and `dispatch` stages each
  micro-batch apart.

Every model is `build_edge_vit(image=16, patch=8, dim=48, heads=4,
layers=2, n_classes=10)`, JAX's seeded init carried across by
`convert.params_from_numpy`.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.launch import admission as j_adm
from repro.launch import vision_serve as j_serve
from repro.models import vit as j_vit
from repro_torch.convert import calibrator_from_scales, params_from_numpy
from repro_torch.launch import admission as t_adm
from repro_torch.launch import serve as t_cli
from repro_torch.launch import vision_serve as t_serve

FLOAT_TOL = 1e-5          # float logits, absolute, tiny width
INT8_REL = 0.02           # int8 logits, share of the logit scale


@functools.lru_cache(maxsize=None)
def _tiny():
    """JAX cfg, params, int8 params, frozen calibrator and an 8-image
    bank."""
    cfg = j_serve.build_edge_vit(image=16, patch=8, dim=48, heads=4,
                                 layers=2, n_classes=10)
    params = j_vit.init_params(jax.random.PRNGKey(0), cfg)
    qparams = j_vit.quantize_vit(params)
    images = np.random.default_rng(0).standard_normal(
        (8, cfg.image, cfg.image, 3)).astype(np.float32)
    cal = j_serve.calibrate(qparams, cfg, images, n_batches=2)
    return cfg, params, qparams, cal, images


def _t_cfg():
    return t_serve.build_edge_vit(image=16, patch=8, dim=48, heads=4,
                                  layers=2, n_classes=10)


def _j_server(buckets, mode="float"):
    cfg, params, qparams, cal, _ = _tiny()
    return j_serve.VisionServer(
        cfg, params, serve_cfg=j_serve.ServeConfig(mode=mode,
                                                   buckets=buckets),
        qparams=qparams, calibrator=cal if mode == "int8" else None)


def _t_server(buckets, mode="float"):
    _, params, qparams, cal, _ = _tiny()
    return t_serve.VisionServer(
        _t_cfg(), params_from_numpy(params),
        serve_cfg=t_serve.ServeConfig(mode=mode, buckets=buckets,
                                      device="cpu"),
        qparams=params_from_numpy(qparams),
        calibrator=calibrator_from_scales(cal.frozen) if mode == "int8"
        else None)


@functools.lru_cache(maxsize=None)
def _j_bank_logits(mode: str) -> np.ndarray:
    """The JAX server's logits for each bank image (one micro-batch)."""
    server = _j_server((8,), mode)
    reqs = server.submit_many(_tiny()[4])
    server.run()
    return np.stack([r.logits for r in reqs])


def _check_logits(mode, got, want):
    assert got.shape == want.shape
    if mode == "float":
        np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert np.abs(got - want).max() <= INT8_REL * np.abs(want).max()


# ---------------------------------------------------------------------------
# select_bucket
# ---------------------------------------------------------------------------


def _table(seed: int):
    """tests/test_admission.py's random table: 1-4 buckets of {1,2,4,8,16}
    at latencies in (0.5, 50) ms, not monotone in the bucket."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    buckets = rng.choice([1, 2, 4, 8, 16], size=n, replace=False)
    return {int(b): float(rng.uniform(0.5, 50.0)) for b in buckets}


@settings(max_examples=60)
@given(st.integers(min_value=0, max_value=10_000),
       st.floats(min_value=0.0, max_value=60.0),
       st.floats(min_value=0.0, max_value=60.0))
def test_select_bucket_matches_jax_and_keeps_the_contract(seed, a, b):
    table = _table(seed)
    lo, hi = sorted((a, b))
    for budget in (lo, hi, None, float("inf")):
        assert t_adm.select_bucket(budget, table) == \
            j_adm.select_bucket(budget, table)
    choice = t_adm.select_bucket(lo, table)
    feasible = [k for k in table if table[k] <= lo]
    if feasible:
        assert table[choice] <= lo and choice == max(feasible)
    else:
        assert choice == min(table)
    assert choice <= t_adm.select_bucket(hi, table)
    with pytest.raises(ValueError):
        t_adm.select_bucket(lo, {})


# ---------------------------------------------------------------------------
# Traces, bench tables and the stats row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["m", ("m1", "m2", "m3")])
@pytest.mark.parametrize("sla", [None, 12.5])
def test_poisson_trace_equals_jax(model, sla):
    kw = dict(sla_ms=sla, seed=7, n_images=5)
    got = t_adm.poisson_trace(300.0, 40, model, **kw)
    want = j_adm.poisson_trace(300.0, 40, model, **kw)
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]


def test_load_trace_equals_jax(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"arrivals": [
        {"t": 0.5, "model": "b"}, {"t": 0.1, "sla_ms": 5.0},
        {"t": 0.3}] + [{"t": 1.0 + i} for i in range(9)]}))
    for sla in (None, 20.0):
        got = t_adm.load_trace(str(path), "a", sla)
        want = j_adm.load_trace(str(path), "a", sla)
        assert [tuple(vars(a).values()) for a in got] == \
            [tuple(vars(a).values()) for a in want]


BENCH = {"runs": [
    {"model": "m", "mode": "float", "batch": 4, "fused": True,
     "wall_s": 0.4, "batches": 100, "mesh_shape": "1x1"},
    {"model": "m", "mode": "float", "batch": 4, "fused": True,
     "wall_s": 0.2, "batches": 100},
    {"model": "m", "mode": "float", "batch": 1, "fused": True,
     "wall_s": 0.1, "batches": 100},
    {"model": "m", "mode": "float", "batch": 1, "fused": True,
     "wall_s": 0.01, "batches": 100, "latency_path": True},
    {"model": "m", "mode": "float", "batch": 2, "fused": True,
     "wall_s": 0.01, "batches": 100, "mesh_shape": "2x1"},
    {"model": "m", "mode": "float", "batch": 4, "fused": True,
     "wall_s": 0.01, "batches": 100, "load_path": True},
    {"model": "m", "mode": "int8", "batch": 4, "fused": True,
     "wall_s": 0.9, "batches": 100},
    {"model": "m", "mode": "float", "batch": 8, "fused": False,
     "wall_s": 0.01, "batches": 100}]}


@pytest.mark.parametrize("model,mode,mesh", [
    ("m", "float", "1x1"), ("m", "int8", "1x1"), ("m", "float", "2x1"),
    ("x", "float", "1x1")])
def test_latency_table_from_bench_equals_jax(tmp_path, model, mode, mesh):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(BENCH))
    want = j_adm.latency_table_from_bench(BENCH, model, mode,
                                          mesh_shape=mesh)
    assert t_adm.latency_table_from_bench(BENCH, model, mode,
                                          mesh_shape=mesh) == want
    assert t_adm.latency_table_from_bench(str(path), model, mode,
                                          mesh_shape=mesh) == want


def _stamped(mod, n: int):
    """``n`` requests of ``mod``'s VisionRequest with fixed stamps."""
    rng = np.random.default_rng(n)
    reqs = []
    for i in range(n):
        r = mod.VisionRequest(i, np.zeros((2, 2, 3), np.float32),
                              sla_ms=[None, 3.0, 40.0][i % 3])
        r.t_submit = 100.0 + 0.01 * i
        r.t_start = r.t_submit + float(rng.uniform(0, 0.02))
        r.t_done = r.t_start + float(rng.uniform(0.001, 0.01))
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("n", [0, 1, 7, 30])
def test_stream_summary_equals_jax(n):
    got = t_adm.stream_summary(_stamped(t_serve, n), 0.5)
    want = j_adm.stream_summary(_stamped(j_serve, n), 0.5)
    assert got == want
    assert t_adm.stream_summary(_stamped(t_serve, n), 0.0) == \
        j_adm.stream_summary(_stamped(j_serve, n), 0.0)


def test_remaining_budget_equals_jax():
    for sla in (None, 10.0):
        t = t_serve.VisionRequest(0, None, sla_ms=sla)
        j = j_serve.VisionRequest(0, None, sla_ms=sla)
        t.t_submit = j.t_submit = 5.0
        for now in (5.0, 5.004, 5.02):
            assert t.remaining_budget_ms(now) == j.remaining_budget_ms(now)


# ---------------------------------------------------------------------------
# Scheduling parity, decision for decision
# ---------------------------------------------------------------------------

T0 = 1000.0


def _sub(model, dt, sla=None):
    return ("submit", model, T0 + dt, sla)


def _step(dt):
    return ("step", T0 + dt)


# name -> (lanes {model: buckets}, tables, latency server lanes with their
# fixed batch-1 ms, max_inflight, script)
SCENARIOS = {
    "edf order": (
        {"a": (1, 2)}, {"a": {1: 1.0, 2: 1.5}}, {}, 1,
        [_sub("a", 0.0), _sub("a", 0.0, 50.0), _sub("a", 0.0, 10.0),
         _sub("a", 0.0, 30.0), _step(0.001), _step(0.002)]),
    "deepest queue, round-robin tie": (
        {"a": (2,), "b": (2,)}, {"a": {2: 1.0}, "b": {2: 1.0}}, {}, 1,
        [_sub("b", 0.0), _sub("a", 0.0), _sub("a", 0.0), _step(0.001),
         _sub("a", 0.002), _step(0.003), _step(0.004)]),
    "partial bucket held": (
        {"a": (4,)}, {"a": {4: 1.0}}, {}, 2,
        [*[_sub("a", 0.0) for _ in range(5)], _step(0.001),
         _sub("a", 0.002), _step(0.003), _step(0.004)]),
    "blown deadline served for throughput": (
        {"a": (1, 4)}, {"a": {1: 1.0, 4: 3.0}}, {}, 1,
        [_sub("a", 0.0, 5.0), _sub("a", 0.0), _sub("a", 0.0, 2.5),
         _step(0.010), _step(0.011)]),
    "single routed to the latency server": (
        {"a": (1, 2, 4)}, {"a": {1: 500.0, 2: 600.0, 4: 700.0}}, {"a": 5.0},
        2, [_sub("a", 0.0, 100.0), _sub("a", 0.0), _step(0.001),
            _step(0.002)]),
    "shrink to a smaller feasible bucket": (
        {"a": (1, 2, 4)}, {"a": {1: 1.0, 2: 2.0, 4: 3.0}}, {}, 1,
        [_sub("a", 0.0), _sub("a", 0.0), _step(0.001),
         _sub("a", 0.002, 2.5), _sub("a", 0.002, 1.5), _sub("a", 0.002),
         _step(0.0025), _step(0.003), _step(0.004)]),
    "no shrink to a slower bucket": (
        {"a": (1, 2, 4)}, {"a": {1: 1.0, 2: 5.0, 4: 3.0}}, {}, 1,
        [_sub("a", 0.0), _sub("a", 0.0), _step(0.001),
         _sub("a", 0.002, 4.0), _sub("a", 0.002, 4.0), _step(0.0025)]),
}


def _drive(adm, make_server, scenario):
    """Run a scenario's script through ``adm``'s controller; returns the
    dispatches (lane, request ids, bucket, path) and the counters."""
    lanes, tables, latency, max_inflight, script = scenario
    log = []

    def recording(server, lane, path):
        inner = server.dispatch

        def dispatch(group, bucket=None):
            log.append((lane, [r.rid for r in group], bucket, path))
            return inner(group, bucket)
        server.dispatch = dispatch
        return server

    servers = {m: recording(make_server(b), m, "throughput")
               for m, b in lanes.items()}
    lat_servers = {m: recording(make_server((1,)), m, "latency")
                   for m in latency}
    ctl = adm.AdmissionController(servers, latencies=tables,
                                  latency_servers=lat_servers or None,
                                  max_inflight=max_inflight)
    for m, ms in latency.items():            # fixed, not measured
        ctl.lanes[m].latency_b1_ms = ms
    images = _tiny()[4]
    for i, ev in enumerate(script):
        if ev[0] == "submit":
            _, m, t, sla = ev
            ctl.submit(m, images[i % len(images)], sla_ms=sla, t_submit=t)
        else:
            ctl.step(ev[1])
    while ctl.pending or ctl.ring:
        ctl.step(script[-1][1] + 1.0)
    counters = (ctl.infeasible_served, ctl.held_partials,
                ctl.routed_latency_path)
    paths = {r.rid: r.path for r in ctl.completed}
    return log, counters, paths, ctl


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduling_matches_jax(name):
    got = _drive(t_adm, _t_server, SCENARIOS[name])
    want = _drive(j_adm, _j_server, SCENARIOS[name])
    assert got[:3] == want[:3]
    log, (infeasible, held, routed), paths, ctl = got
    n = sum(1 for ev in SCENARIOS[name][4] if ev[0] == "submit")
    assert len(ctl.completed) == n and sorted(paths) == list(range(n))
    # each scenario shows the decision it is named for
    if name == "edf order":
        assert log[0][1] == [2, 3] and log[1][1] == [1, 0]
    elif name == "deepest queue, round-robin tie":
        assert [e[0] for e in log] == ["a", "b", "a"]
    elif name == "partial bucket held":
        assert held >= 1 and [len(e[1]) for e in log] == [4, 2]
    elif name == "blown deadline served for throughput":
        assert log[0][2] == 4 and 0 in log[0][1]
    elif name == "single routed to the latency server":
        assert routed == 1 and paths[0] == "latency" and log[0][3] == \
            "latency"
    elif name == "shrink to a smaller feasible bucket":
        assert log[0][2] == 2 and infeasible == 0
    elif name == "no shrink to a slower bucket":
        assert log[0][2] == 4 and len(log[0][1]) == 2


# ---------------------------------------------------------------------------
# Open stream and drain baseline on the CPU, against the JAX server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["float", "int8"])
def test_open_stream_logits_match_jax(mode):
    images = _tiny()[4]
    ctl = t_adm.AdmissionController(
        {"edge": _t_server((1, 2, 4), mode)},
        latencies={"edge": {1: 1.0, 2: 1.2, 4: 1.5}})
    trace = t_adm.poisson_trace(2000.0, 16, "edge", sla_ms=200.0, seed=3,
                                n_images=len(images))
    stats = t_adm.run_open_stream(ctl, trace, {"edge": images})
    assert stats["requests"] == 16 and stats["infeasible_served"] == 0
    assert stats["per_model"] == {"edge": 16}
    assert set(j_adm.stream_summary([], 1.0)) <= set(stats)
    done = sorted(ctl.completed, key=lambda r: r.rid)
    got = np.stack([r.logits for r in done])
    want = _j_bank_logits(mode)[[a.image_idx for a in trace]]
    _check_logits(mode, got, want)


def test_drain_stream_logits_match_jax():
    images = _tiny()[4]
    server = _t_server((1, 2, 4))
    trace = t_adm.poisson_trace(2000.0, 8, "edge", sla_ms=500.0, seed=1,
                                n_images=len(images))
    stats = t_adm.run_drain_stream(server, trace, {"edge": images})
    assert stats["requests"] == 8 and stats["throughput_img_s"] > 0
    assert set(stats) == set(j_adm.stream_summary([], 1.0))
    got = np.stack([r.logits for r in server.done])
    _check_logits("float", got,
                  _j_bank_logits("float")[[a.image_idx for a in trace]])


def test_multiplex_and_latency_path_serve_every_arrival():
    images = _tiny()[4]
    servers = {"a": _t_server((1, 2, 4)), "b": _t_server((2, 4))}
    lat = _t_server((1,))
    ctl = t_adm.AdmissionController(
        servers, latencies={"a": {1: 500.0, 2: 600.0, 4: 700.0},
                            "b": {2: 1.0, 4: 1.5}},
        latency_servers={"a": lat})
    trace = t_adm.poisson_trace(3000.0, 24, ("a", "b"), sla_ms=100.0,
                                seed=5, n_images=len(images))
    stats = t_adm.run_open_stream(ctl, trace, {"a": images, "b": images})
    want = {m: sum(1 for a in trace if a.model == m) for m in ("a", "b")}
    assert stats["per_model"] == want and stats["requests"] == 24
    assert stats["routed_latency_path"] == len(lat.done) > 0
    done = sorted(ctl.completed, key=lambda r: r.rid)
    _check_logits("float", np.stack([r.logits for r in done]),
                  _j_bank_logits("float")[[a.image_idx for a in trace]])


def test_measure_bucket_latencies_leaves_the_server_as_it_was():
    server = _t_server((1, 2))
    inner = server.complete

    def complete(inflight):                   # as the card appends a time
        server.device_ms.append(1.25)
        return inner(inflight)
    server.complete = complete
    server.submit_many(_tiny()[4][:3])
    server.run()
    before = (list(server.done), server.n_batches, server.n_padded,
              list(server.device_ms))
    table = t_adm.measure_bucket_latencies(server, repeats=2)
    assert set(table) == {1, 2} and all(ms > 0 for ms in table.values())
    assert (list(server.done), server.n_batches, server.n_padded,
            list(server.device_ms)) == before


def test_controller_measures_missing_tables():
    server = _t_server((1, 2))
    ctl = t_adm.AdmissionController({"e": server}, latencies={"e": {1: 2.0}})
    assert ctl.lanes["e"].latencies[1] == 2.0
    assert ctl.lanes["e"].latencies[2] > 0 and not server.done


# ---------------------------------------------------------------------------
# The server's hooks
# ---------------------------------------------------------------------------


def test_run_row_has_every_key_of_jax():
    t_srv, j_srv = _t_server((1, 2)), _j_server((1, 2))
    empty_t, empty_j = t_srv.run(), j_srv.run()
    assert set(empty_j) <= set(empty_t)
    for k in ("latency_p50_ms", "latency_p99_ms", "latency_mean_ms",
              "queue_delay_p50_ms", "service_p50_ms", "throughput_img_s"):
        assert empty_t[k] == empty_j[k] == 0.0
    assert (empty_t["devices"], empty_t["mesh_shape"]) == (1, "1x1")
    assert empty_t["device_p50_ms"] is None
    images = _tiny()[4][:3]
    t_srv.submit_many(images)
    j_srv.submit_many(images)
    row, j_row = t_srv.run(), j_srv.run()
    assert set(j_row) <= set(row)
    for k in ("requests", "batches", "padded", "devices", "mesh_shape",
              "fused_buckets", "group_buckets"):
        assert row[k] == j_row[k]
    assert row["latency_p99_ms"] >= row["latency_p50_ms"] > 0
    assert row["queue_delay_p50_ms"] >= 0


def test_dispatch_stages_each_micro_batch_apart():
    """Two micro-batches dispatched in a row, neither completed, each keep
    their own images (the staging buffer is never shared between two
    micro-batches), and padding counts in ``n_padded``."""
    images = _tiny()[4]
    server = _t_server((2, 4))
    reqs = [t_serve.VisionRequest(i, im) for i, im in enumerate(images)]
    first = server.dispatch(reqs[:3])
    second = server.dispatch(reqs[3:7])
    assert (first.bucket, second.bucket) == (4, 4)
    assert server.n_padded == 1 and server.n_batches == 2
    assert first.t_dispatch is not None
    server.complete(second)
    server.complete(first)
    staged = [server._stage(reqs[:3], 4), server._stage(reqs[3:7], 4)]
    assert staged[0].data_ptr() != staged[1].data_ptr()
    assert torch.equal(staged[0][:3], torch.from_numpy(images[:3]))
    got = np.stack([r.logits for r in first.requests + second.requests])
    _check_logits("float", got, _j_bank_logits("float")[:7])
    alone = server.forward(torch.from_numpy(images[:1]))[0].numpy()
    np.testing.assert_allclose(first.requests[0].logits, alone, rtol=0,
                               atol=FLOAT_TOL)


def test_padding_counts_and_pads_with_zeros():
    server = _t_server((4,))
    reqs = server.submit_many(_tiny()[4][:1])
    staged = server._stage(reqs, 4)
    assert staged.shape == (4, 16, 16, 3) and not staged[1:].any()
    assert torch.equal(staged[0], torch.from_numpy(_tiny()[4][0]))
    server.run()
    assert server.n_padded == 3


def test_restamp_queued_resets_submit_clocks():
    server = _t_server((2,))
    reqs = server.submit_many(_tiny()[4][:2])
    for r in reqs:
        r.t_submit = 0.0
    server.restamp_queued()
    assert all(r.t_submit > 0 for r in reqs)


def test_build_edge_vit_matches_jax():
    t_cfg, j_cfg = _t_cfg(), _tiny()[0]
    for f in ("name", "image", "patch", "dim", "heads", "layers",
              "n_classes", "mlp_ratio"):
        assert getattr(t_cfg, f) == getattr(j_cfg, f)


def test_serve_stream_rows_and_refusals():
    trace = t_adm.poisson_trace(2000.0, 6, ("deit_t", "vit_edge"),
                                sla_ms=500.0, seed=2)
    rows = t_serve.serve_stream(["deit_t", "vit_edge"], modes=("float",),
                                buckets=(1, 2), trace=trace, device="cpu")
    (row,) = rows
    assert row["requests"] == row["offered"] == 6
    assert (row["devices"], row["mesh_shape"], row["device"]) == \
        (1, "1x1", "cpu")
    assert row["model"] == "deit_t,vit_edge"
    one = [a for a in trace if a.model == "vit_edge"]
    (drain,) = t_serve.serve_stream(["vit_edge"], modes=("int8",),
                                    buckets=(1, 2), trace=one,
                                    serving="drain", device="cpu")
    assert drain["requests"] == len(one) and drain["serving"] == "drain"
    # Meshes are served (tests/test_torch_mesh_serve.py); a malformed
    # mesh shape is refused before any rank starts.
    for kw in (dict(mesh_shape="0x2"), dict(latency_mesh="1x2x3")):
        with pytest.raises(ValueError, match="mesh shape"):
            t_serve.serve_stream(["vit_edge"], modes=("float",),
                                 buckets=(1,), trace=one, device="cpu",
                                 **kw)
    with pytest.raises(ValueError):
        t_serve.serve_stream(["deit_t", "vit_edge"], modes=("float",),
                             buckets=(1,), trace=trace, serving="drain",
                             device="cpu")


def test_cli_open_stream_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "stream.json"
    rows = t_cli.main(["--vision", "--model", "vit_edge,deit_t",
                       "--arrival-rate", "2000", "--sla-ms", "500",
                       "--requests", "6", "--buckets", "1,2", "--mode",
                       "float", "--device", "cpu", "--json-out", str(out)])
    assert [r["serving"] for r in rows] == ["continuous"]
    assert rows[0]["requests"] == 6
    record = json.loads(out.read_text())
    want = t_adm.poisson_trace(2000.0, 6, ["vit_edge", "deit_t"],
                               sla_ms=500.0, seed=0)
    assert record["device"] == "cpu"
    assert record["models"] == sorted({a.model for a in want})
    assert record["runs"][0]["per_model"] == {
        m: sum(1 for a in want if a.model == m) for m in record["models"]}
    assert "serving=continuous on cpu" in capsys.readouterr().out
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"arrivals": [{"t": 0.0}, {"t": 0.001}]}))
    rows = t_cli.main(["--vision", "--model", "vit_edge", "--trace",
                       str(trace), "--serving", "drain", "--mode", "int8",
                       "--device", "cpu"])
    assert rows[0]["requests"] == 2 and rows[0]["serving"] == "drain"
    with pytest.raises(SystemExit):
        t_cli.main(["--vision", "--model", "vit_edge,deit_t", "--device",
                    "cpu"])
    with pytest.raises(SystemExit):
        t_cli.main(["--vision", "--model", "nope", "--arrival-rate", "10",
                    "--device", "cpu"])
