"""The result line, a run on the CPU end to end, and the refusals: no
card, no result; a traced run whose profiler saw no device time fails."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

import run as bench_run
from conftest import BENCH, ROOT
from harness import trace


def test_result_line_keys_in_order():
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
              "device": {"platform": "gpu"}, "extra": 1}
    line = bench_run.result_line(result, {"logit_gap": (1e-6, 1e-4)})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["compared"] == {"logit_gap": {"value": 1e-6, "limit": 1e-4}}
    result["breakdown"] = {"device_ops": [], "idle_gaps": []}
    line = bench_run.result_line(result, {"logit_gap": (1e-6, 1e-4)})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]


@pytest.mark.parametrize("workload,metrics", [
    ("vit_tiny.backlog", {"img_per_s", "setup_s"}),
    ("swin_tiny.backlog", {"img_per_s", "setup_s"}),
    ("vit_tiny.poisson", {"img_per_s", "setup_s"}),
])
def test_a_cpu_run_reports_its_cells_end_to_end_metrics(run_tiny, workload,
                                                        metrics):
    result, compared, run = run_tiny(workload)
    assert result["correct"] and result["failed"] == 0, compared
    assert set(result["metrics"]) == metrics
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] == len(run.requests) > 0
    assert compared["logit_gap"][0] < compared["logit_gap"][1]


def test_per_layer_readers_read_a_traced_record(run_tiny):
    """The per-layer readers over a run record with a trace summary (made
    up: a CPU run has no device trace)."""
    from harness import spec
    result, compared, run = run_tiny("vit_tiny.backlog")
    run.summary = trace.Summary(window_s=2.0, busy_s=1.5, device_ops=[],
                                idle_gaps=[], layer_device_s=[0.5],
                                layer_calls=[0])
    run.dispatch_ms, run.micro_batch_device_ms = [2.0, 4.0], [10.0, 12.0]
    run.layer_least_device_s = (0.05, 0.5)
    got = {m["name"]: spec.load_metric(m["name"]).read(run)
           for m in spec.load_benchmark(ROOT)["per_layer"]}
    assert got["device_idle_pct.backlog"] == pytest.approx(25.0)
    assert got["dispatch_host_ms.backlog"] == pytest.approx(3.0)
    assert got["step_device_ms.backlog"] == pytest.approx(11.0)
    assert got["vita_layer_roofline.backlog"] == pytest.approx(10.0)
    assert 0 < got["mfu_pct.backlog"] < 100
    batches = {r.t_start for r in run.requests}
    assert got["images_per_batch.poisson"] == pytest.approx(
        len(run.requests) / len(batches))
    assert 1 <= got["images_per_batch.poisson"] <= 4     # buckets 1-4
    lat = sorted(r.latency_s * 1e3 for r in run.requests)
    assert lat[0] <= got["latency_p50_ms.poisson"] <= \
        got["latency_p95_ms.poisson"] <= lat[-1]
    assert got["latency_p50_ms.poisson"] == pytest.approx(
        float(np.median(lat)))


def test_a_traced_run_without_device_time_fails(run_tiny):
    with pytest.raises((RuntimeError, ValueError)):
        run_tiny("vit_tiny.backlog", traced=True)


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "deit_s.fp32.backlog", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "deit_s.fp32.backlog", "--seed", str(2 ** 31 + 9), "--seconds", "2",
         "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
