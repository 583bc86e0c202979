"""The port's tracer (`repro_torch.trace`) on the CPU: a tiny
`VisionServer(device="cpu")` behind an `AdmissionController`.

* Off (the default), a served micro-batch leaves no record and enters no
  profiler range.
* On, every micro-batch yields its dispatch, stage, copy, forward, phase,
  complete, wait and readback spans, nested by parent and sharing one
  ``batch`` id, which each request carries; wait and readback carry a0 0
  (the CPU reads back synchronously).
* The collector's passes are spans; `disable` removes the hook.
* The cap counts what it drops; `kernels.build.call` counts launches and
  their host ns; the admission layer's latency probes leave nothing.
* Any module may declare a counter by a name of its own and count it:
  it shows in `counters`, counts only while tracing is on, and `rewind`
  and `reset` take it back.  A collection that starts inside the
  tracer's own lock records its span without a deadlock.
* A TNT forward's kernel-1 spans carry each stream's shape, inner then
  outer; `vita_msa.launch_msa` counts its tile's rows and padded rows
  from its plan, and on the packed route (TNT-S's pixel stream) its rows
  again as packed rows (the launch itself stubbed out), and the CPU's
  plain path, which launches no tile, counts none.
* Under the CPU `torch.profiler` each span has one range of its name, in
  the same order, and `to_trace_clock` places each span's start within
  0.5 ms of its range's start.
"""

import gc
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.launch import admission as adm
from repro_torch.launch import vision_serve as vs
from repro_torch.models import vit

SERVING = ("vita.server.dispatch", "vita.server.stage", "vita.server.copy",
           "vita.server.forward", "vita.server.complete", "vita.server.wait",
           "vita.server.readback")


@pytest.fixture
def tracer():
    """The tracer, switched off and emptied again after the test."""
    trace.disable()
    trace.reset()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _server(buckets=(1, 2, 4)):
    cfg = vs.build_edge_vit(image=16, patch=8, dim=48, heads=4, layers=2,
                            n_classes=10)
    return vs.VisionServer(cfg, vit.init_params(cfg, seed=0),
                           serve_cfg=vs.ServeConfig(buckets=buckets,
                                                    device="cpu"))


def _controller(server):
    return adm.AdmissionController(
        {"m": server}, latencies={"m": {1: 1.0, 2: 2.0, 4: 3.0}})


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)


def _serve(ctl, n=6):
    reqs = [ctl.submit("m", im) for im in _images(n)]
    ctl.drain()
    return reqs


def _count(by_name):
    """Add each value of ``by_name`` to the counter of its name."""
    for name, n in by_name.items():
        trace.count(name, n)


def test_off_a_micro_batch_leaves_no_record_and_no_range(tracer,
                                                         monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *a, **k):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", Counting)
    ctl = _controller(_server())
    reqs = _serve(ctl)
    assert all(r.t_done is not None for r in reqs)
    assert not trace.ON
    assert len(trace.records()) == 0 and entered == []
    assert trace.counters() == {"kernels.launches": 0, "kernels.launch_ns": 0,
                                "kernels.msa_rows": 0,
                                "kernels.msa_tile_rows": 0,
                                "kernels.msa_packed_rows": 0,
                                "kernels.gemm_macs": 0,
                                "kernels.gemm_wgmma_macs": 0,
                                "kernels.gemm_tile_macs": 0,
                                "spans": 0, "dropped": 0}
    assert all(r.batch is None for r in reqs)


def test_on_every_micro_batch_has_its_spans_nested_under_one_batch(tracer):
    ctl = _controller(_server())
    trace.enable(cap=10_000)
    reqs = _serve(ctl, 6)                  # buckets 4 then 2
    trace.disable()
    spans = trace.records().spans()
    by_id = {s.id: s for s in spans}
    dispatches = [s for s in spans if s.name == "vita.server.dispatch"]
    assert [(d.a0, d.a1) for d in dispatches] == [(4, 4), (2, 2)]
    for d in dispatches:
        assert d.batch == d.id
        mine = [s for s in spans if s.batch == d.id]
        names = {s.name for s in mine}
        assert set(SERVING) <= names
        assert {"vita.phase.embed", "vita.phase.layer", "vita.phase.head",
                "vita.kernels.vita_layer"} <= names
        assert all(s.end is not None and s.end >= s.start for s in mine)

        def one(name):
            got = [s for s in mine if s.name == name]
            assert len(got) == 1, name
            return got[0]
        for child in ("vita.server.stage", "vita.server.copy",
                      "vita.server.forward"):
            assert one(child).parent == d.id
        fwd = one("vita.server.forward")
        phases = [s for s in mine if s.name.startswith("vita.phase.")]
        assert [p.a0 for p in phases] == [0, 1, 2, 3]
        assert all(p.parent == fwd.id for p in phases)
        for k in (s for s in mine if s.name == "vita.kernels.vita_layer"):
            assert by_id[k.parent].name == "vita.phase.layer"
        done = one("vita.server.complete")
        assert one("vita.server.wait").parent == done.id
        assert one("vita.server.readback").parent == done.id
        # the CPU reads back synchronously: no pinned copy, no wait
        assert one("vita.server.wait").a0 == one("vita.server.readback").a0 \
            == 0
        assert by_id[d.parent].name == by_id[done.parent].name == \
            "vita.admission.step"
        # nested in time, too
        for s in mine:
            if s.parent >= 0 and s.name != "vita.server.complete":
                p = by_id[s.parent]
                assert p.start <= s.start <= s.end <= p.end
        assert one("vita.server.stage").a0 == d.a0 * 16 * 16 * 3 * 4
    assert [r.batch for r in reqs] == [dispatches[0].id] * 4 + \
        [dispatches[1].id] * 2
    submits = [s for s in spans if s.name == "vita.admission.submit"]
    assert [s.a0 for s in submits] == [r.rid for r in reqs]


def test_assemble_flags_a_held_partial_bucket(tracer):
    # a smaller bucket measured slower: a part-filled pick is held back
    # while the ring is busy rather than shrunk
    ctl = adm.AdmissionController(
        {"m": _server()}, latencies={"m": {1: 5.0, 2: 5.0, 4: 3.0}})
    trace.enable(cap=10_000)
    for im in _images(5):
        ctl.submit("m", im)
    ctl.step()                 # dispatches 4 and the held 1, completes 4
    ctl.drain()
    trace.disable()
    assembles = [s for s in trace.records().spans()
                 if s.name == "vita.admission.assemble"]
    assert ctl.held_partials == sum(s.a0 for s in assembles) >= 1


def test_the_collector_is_a_span_and_disable_removes_the_hook(tracer):
    trace.enable(cap=100)
    assert trace._on_gc in gc.callbacks
    gc.collect(1)
    trace.disable()
    assert trace._on_gc not in gc.callbacks
    got = [s for s in trace.records().spans() if s.name == "vita.host.gc"]
    assert got and got[-1].a0 == 1 and got[-1].end >= got[-1].start
    n = len(trace.records())
    gc.collect()
    assert len(trace.records()) == n


def test_the_cap_counts_what_it_drops(tracer):
    trace.enable(cap=5)
    gc.disable()
    try:
        for i in range(8):
            with trace.span("vita.test", -1, i):
                pass
    finally:
        gc.enable()
    trace.disable()
    assert len(trace.records()) == 5
    assert [s.a0 for s in trace.records().spans()] == [0, 1, 2, 3, 4]
    c = trace.counters()
    assert (c["spans"], c["dropped"]) == (5, 3)
    trace.reset()
    assert trace.counters()["dropped"] == 0 and len(trace.records()) == 0


def test_build_call_counts_launches_and_their_host_time(tracer,
                                                        monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(build, "library",
                        lambda name: types.SimpleNamespace(rt_fake=entry))
    build.call("fake", "rt_fake", 1, 2)            # off: not counted
    trace.enable(cap=100)
    with trace.launch_span("vita.server.forward") as sp:
        for i in range(3):
            build.call("fake", "rt_fake", i)
    build.call("fake", "rt_fake", 9)               # outside the span
    trace.disable()
    assert len(calls) == 5
    c = trace.counters()
    assert c["kernels.launches"] == 4 and c["kernels.launch_ns"] > 0
    fwd = trace.records().spans()[sp.id]
    assert fwd.a0 == 3 and 0 < fwd.a1 <= c["kernels.launch_ns"]
    monkeypatch.setattr(build, "library", lambda name: types.SimpleNamespace(
        rt_fake=lambda *a: 7))
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        build.call("fake", "rt_fake")


def test_loading_a_library_is_a_build_span(tracer, monkeypatch):
    class Lib:
        def __getattr__(self, sym):
            return types.SimpleNamespace()
    monkeypatch.setattr(build, "build_all", lambda names: {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.delitem(build._loaded, "layer_norm", raising=False)
    trace.enable(cap=100)
    build.library("layer_norm")
    build.library("layer_norm")                    # loaded: no span
    trace.disable()
    monkeypatch.delitem(build._loaded, "layer_norm")
    got = [s for s in trace.records().spans()
           if s.name == "vita.kernels.build"]
    assert [s.a0 for s in got] == [build.LIBRARIES.index("layer_norm")]


def test_latency_probes_leave_no_spans_or_counts(tracer):
    server = _server((1, 2))
    trace.enable(cap=10_000)
    with trace.span("vita.test.before"):
        pass
    _count({"kernels.launches": 1, "kernels.launch_ns": 5})
    before = (trace.counters(), trace.records().spans())
    gc.disable()
    try:
        ctl = adm.AdmissionController({"m": server}, measure_repeats=2)
        assert set(ctl.lanes["m"].latencies) == {1, 2}
        assert (trace.counters(), trace.records().spans()) == before
        ctl.submit("m", _images(1)[0])
        ctl.drain()
    finally:
        gc.enable()
    trace.disable()
    names = [s.name for s in trace.records().spans()]
    assert names[0] == "vita.test.before"
    assert names.count("vita.server.dispatch") == 1


def test_mark_and_rewind_take_back_spans_and_counts(tracer):
    trace.enable(cap=100)
    with trace.span("vita.test.kept"):
        pass
    at = trace.mark()
    with trace.span("vita.test.gone"):
        _count({"kernels.launches": 1, "kernels.launch_ns": 10})
    trace.rewind(at)
    trace.disable()
    assert [s.name for s in trace.records().spans()] == ["vita.test.kept"]
    assert trace.counters()["kernels.launches"] == 0


def test_any_module_may_declare_and_count_a_counter(tracer, monkeypatch):
    """A counter the tracer has never heard of: declared, it reads 0;
    it counts only while tracing is on; `rewind` takes back what was
    counted since `mark`, and `reset` zeroes it.  (The declared counters
    are restored afterwards, so later tests see the port's alone.)"""
    monkeypatch.setattr(trace._S, "counts", dict(trace._S.counts))
    rows = trace.counter("test.widget_rows")
    assert trace.counters()["test.widget_rows"] == 0
    trace.count(rows, 7)
    assert trace.counters()["test.widget_rows"] == 0
    trace.enable(cap=100)
    trace.count(rows, 7)
    at = trace.mark()
    trace.count(rows, 5)
    trace.count(rows)
    assert trace.counters()["test.widget_rows"] == 13
    trace.rewind(at)
    assert trace.counters()["test.widget_rows"] == 7
    trace.reset()
    assert trace.counters()["test.widget_rows"] == 0
    trace.disable()
    assert list(trace.counters())[-2:] == ["spans", "dropped"]


def test_a_collection_inside_the_tracers_lock_does_not_deadlock():
    """A call inside a region that holds the tracer's lock may run a
    pending collection, whose `vita.host.gc` span takes the lock again.
    With a collection due at nearly every allocation, snapshots and
    rewinds inside spans finish (in a child process, so a deadlock fails
    the test instead of hanging the run), and every span keeps its name."""
    code = textwrap.dedent("""
        import gc
        from repro_torch import trace
        from repro_torch.kernels import build
        trace.enable(cap=100_000)
        gc.set_threshold(1)
        for i in range(3_000):
            with trace.span(f"vita.test.{i % 7}"):
                trace.counters()
                trace.rewind(trace.mark())
        gc.set_threshold(700)
        trace.disable()
        names = [s.name for s in trace.records().spans()]
        assert names.count("vita.host.gc") > 0
        assert sum(n.startswith("vita.test.") for n in names) == 3_000
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(trace.__file__).parents[1])]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    try:
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        pytest.fail("the tracer deadlocked under a collection")
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _tnt():
    """TNT-S's token counts (196 patches of 16 pixel tokens) at CPU
    widths: (config, params, two images' patches)."""
    from repro_torch.models import tnt
    cfg = tnt.TNTConfig(name="tnt_trace", image=224, patch=16,
                        inner_patch=4, dim=16, inner_dim=8, heads=2,
                        inner_heads=2, layers=2, n_classes=10)
    images = torch.randn((2, 224, 224, 3),
                         generator=torch.Generator().manual_seed(0))
    return cfg, tnt.init_params(cfg, seed=0), vit.extract_patches(images, 16)


def test_a_tnt_forward_tells_the_two_streams_apart(tracer):
    from repro_torch.models import tnt
    cfg, params, patches = _tnt()
    trace.enable(cap=1_000)
    with torch.no_grad():
        tnt.forward(params, patches, cfg)
    trace.disable()
    layers = [s for s in trace.records().spans()
              if s.name == "vita.kernels.vita_layer"]
    # a0 the tokens a sequence, a1 the sequences: inner (16 pixel tokens,
    # 2 images x 196 patches), then outer (196 patches, 2 images), a layer
    assert [(s.a0, s.a1) for s in layers] == [(16, 392), (196, 2)] * 2
    # the plain path launches no MSA tile
    c = trace.counters()
    assert c["kernels.msa_rows"] == c["kernels.msa_tile_rows"] == 0
    assert c["kernels.msa_packed_rows"] == 0


@pytest.mark.parametrize("n,d,h,dh,b,tile_rows,packed", [
    (16, 24, 4, 6, 3, 4 * 64, True),            # one packed block
    (16, 24, 4, 6, 1570, 393 * 64 * 4, True),   # 393 blocks, the last ragged
    (196, 384, 6, 64, 3, 3 * 6 * 4 * 64, False)])
def test_launch_msa_counts_its_plans_rows(tracer, monkeypatch, n, d, h, dh,
                                          b, tile_rows, packed):
    """At TNT-S's inner shape the packed tile's blocks span ceil(B / 4)
    x 64 rows for each head, and its query rows count again as packed
    rows; at the outer shape the cluster tile gives each (sequence, head)
    four blocks of 64 rows, and nothing counts as packed.  Nothing counts
    while the tracer is off."""
    from repro_torch.kernels import vita_msa
    monkeypatch.setattr(vita_msa, "check", lambda *a, **k: None)
    monkeypatch.setattr(vita_msa, "stream", lambda: 0)
    monkeypatch.setattr(build, "call", lambda *a, **k: None)
    z = torch.zeros((b, n, d))
    w = torch.zeros((h, d, dh))
    out = torch.empty((b, n, h * dh))
    assert (vita_msa.msa_packed_plan(n, d, h, dh) is not None) == packed
    vita_msa.launch_msa(z, w, w, w, out, (n * h * dh, h * dh, dh))
    c = trace.counters()
    assert c["kernels.msa_rows"] == c["kernels.msa_tile_rows"] == 0
    assert c["kernels.msa_packed_rows"] == 0
    trace.enable(cap=100)
    vita_msa.launch_msa(z, w, w, w, out, (n * h * dh, h * dh, dh))
    vita_msa.launch_msa(z, w, w, w, out, (n * h * dh, h * dh, dh))
    trace.disable()
    c = trace.counters()
    assert c["kernels.msa_rows"] == 2 * b * h * n
    assert c["kernels.msa_tile_rows"] == 2 * tile_rows
    assert c["kernels.msa_packed_rows"] == (2 * b * h * n if packed else 0)


def test_off_a_tnt_forward_records_and_counts_nothing(tracer):
    from repro_torch.models import tnt
    cfg, params, patches = _tnt()
    with torch.no_grad():
        tnt.forward(params, patches, cfg)
    assert len(trace.records()) == 0
    c = trace.counters()
    assert c["kernels.msa_rows"] == c["kernels.msa_tile_rows"] == 0
    assert c["kernels.msa_packed_rows"] == 0


def test_rewind_takes_back_the_msa_rows(tracer):
    trace.enable(cap=100)
    _count({"kernels.msa_rows": 10, "kernels.msa_tile_rows": 40,
            "kernels.msa_packed_rows": 10})
    at = trace.mark()
    _count({"kernels.msa_rows": 5, "kernels.msa_tile_rows": 64,
            "kernels.msa_packed_rows": 5})
    trace.rewind(at)
    trace.disable()
    c = trace.counters()
    assert (c["kernels.msa_rows"], c["kernels.msa_tile_rows"],
            c["kernels.msa_packed_rows"]) == (10, 40, 10)


def _profiled_events(prof, prefix="vita."):
    from torch.autograd import DeviceType
    return sorted(((e.name(), e.start_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith(prefix)),
                  key=lambda ev: ev[1])


def test_each_span_is_a_profiler_range_on_the_trace_clock(tracer):
    ctl = _controller(_server())
    _serve(ctl, 2)                         # warm
    gc.disable()
    try:
        trace.enable(cap=10_000)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _serve(ctl, 6)
        trace.disable()
    finally:
        gc.enable()
    spans = trace.records().spans()
    ranges = _profiled_events(prof)
    assert len(spans) > 30
    assert [n for n, _ in ranges] == [s.name for s in spans]
    starts = trace.to_trace_clock(np.array([s.start for s in spans]))
    gap_ms = np.abs(starts - np.array([t for _, t in ranges])) / 1e6
    assert gap_ms.max() < 0.5, gap_ms.max()
    assert trace.to_trace_clock(spans[0].start) == int(starts[0])


def test_off_under_a_profiler_enters_no_vita_range(tracer):
    ctl = _controller(_server())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(ctl, 3)
    assert _profiled_events(prof) == []
