"""The yardstick's counts and the trace reduction, on made-up events."""

from __future__ import annotations

import json

import pytest

from conftest import BENCH
from harness import counts, trace
from harness.trace import Event


@pytest.mark.parametrize("config,gflop", [("deit_s", 9.15), ("swin_t", 8.98)])
def test_flops_per_image(config, gflop):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    flops = counts.flops_per_image(cfg["family"], cfg["sizes"])
    assert round(flops / 1e9, 2) == gflop
    assert cfg["flops_per_image"] == flops


@pytest.mark.parametrize("name", ["deit_s", "swin_t"])
def test_flops_match_the_programs_mac_count(name):
    from repro_torch.core import perfmodel
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    spec = getattr(perfmodel, name)()
    assert counts.macs_per_image(cfg["family"], cfg["sizes"]) == \
        perfmodel.count_macs(spec).total


def test_vita_layer_call_counts_deit_s_at_bucket_32():
    ops, nbytes = counts.vita_layer_call((32, 196, 384), 6, 64, 1536)
    rows = 32 * 196
    assert ops == 2 * rows * (3 * 384 * 384 + 384 * 384 + 2 * 384 * 1536) \
        + 4 * 32 * 6 * 196 * 196 * 64
    weights = 4 * 384 * 384 + 2 * 384 * 1536 + 4 * 384 + 1536 + 384
    assert nbytes == 4 * (2 * rows * 384 + weights)
    # bound by operations at the TF32 peak
    assert counts.least_time_s(ops, nbytes) == ops / counts.TF32_FLOP_S


def test_windowed_call_reads_its_bias_and_mask_once():
    _, plain = counts.vita_layer_call((2048, 49, 96), 3, 32, 384)
    _, windowed = counts.vita_layer_call((2048, 49, 96), 3, 32, 384,
                                         bias_elems=3 * 49 * 49,
                                         mask_elems=64 * 49 * 49)
    assert windowed - plain == 4 * 67 * 49 * 49


def _events():
    """A 100 us window: kernels 10-30 and 25-40 (overlapping, one a copy),
    a kernel-1 range 50-80 holding two kernels, and a kernel outside."""
    return [
        Event("host", trace.WINDOW, 0.0, 100.0, tid=1),
        Event("device", "k_a", 10.0, 30.0),
        Event("device", "Memcpy HtoD", 25.0, 40.0),
        Event("host", trace.LAYER, 46.0, 48.0, tid=1),
        Event("range", trace.LAYER, 50.0, 80.0),
        Event("device", "gemm", 50.0, 60.0),
        Event("device", "gemm", 65.0, 80.0),
        Event("device", "late", 120.0, 130.0),
        Event("host", "VisionServer.complete", 82.0, 99.0, tid=1),
        Event("host", "cudaEventSynchronize", 83.0, 98.0, tid=1),
    ]


def test_reduce_takes_the_union_of_device_intervals():
    s = trace.reduce(_events())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(55e-6)      # 10-40, 50-60, 65-80
    assert s.idle_pct == pytest.approx(45.0)
    assert s.device_ops[0] == ("gemm", pytest.approx(25e-6))


def test_idle_gaps_are_labelled_by_the_host():
    s = trace.reduce(_events())
    gaps = dict((round(v * 1e6), k) for k, v in s.idle_gaps)
    assert set(gaps) == {10, 5, 20}
    assert gaps[20] == "VisionServer.complete > cudaEventSynchronize"
    assert gaps[10] == "host: Python between profiled ops"
    s = trace.reduce(_events() + [Event("host", "VisionServer.dispatch", 1.0,
                                        9.0, tid=1)])
    assert ("VisionServer.dispatch > Python, no torch op",
            pytest.approx(10e-6)) in s.idle_gaps


def test_layer_ranges_take_their_kernels_device_time():
    s = trace.reduce(_events())
    assert s.layer_calls == [0]
    assert s.layer_device_s == [pytest.approx(25e-6)]
    shapes = [((32, 196, 384), 6, 64, 1536, 0, 0, 4)]
    least, took = trace.layer_roofline(s, shapes)
    ops, nbytes = counts.vita_layer_call((32, 196, 384), 6, 64, 1536)
    assert least == counts.least_time_s(ops, nbytes)
    assert took == pytest.approx(25e-6)


def test_unpaired_layer_ranges_read_nothing():
    ev = _events() + [Event("host", trace.LAYER, 90.0, 91.0, tid=1)]
    s = trace.reduce(ev)
    assert s.layer_calls == []
    assert trace.layer_roofline(s, [None, None]) is None


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.reduce([e for e in _events() if e.name != trace.WINDOW])
