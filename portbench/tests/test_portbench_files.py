"""Cells are data: a new configuration, traffic mix or metric is a new
file and a new entry in BENCHMARK.json, found by name."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from harness import spec, traffic as tr


def test_benchmark_json_names_files_that_exist():
    bench = spec.load_benchmark(ROOT)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        tr.parse(cell.traffic)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.load_metric(m["name"], ROOT)
        assert mod.UNIT == m["unit"]
        if m in bench["per_layer"]:
            assert mod.LAYER == m["layer"]
        assert mod.MOVES == (m["moves"] if "moves" in m else m["name"])


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    bench = spec.load_benchmark(ROOT)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


def test_a_new_config_traffic_and_metric_are_found_by_name(tiny_root,
                                                           run_tiny):
    """Add a configuration, a traffic mix, a metric and a cell without
    editing any file's contents but BENCHMARK.json's entries."""
    root = tiny_root
    cfg = json.loads((root / "portbench/configs/vit_tiny.json").read_text())
    cfg.update(name="vit_tiny3")
    cfg["sizes"] = dict(cfg["sizes"], layers=3)
    (root / "portbench/configs/vit_tiny3.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/closed3.json").write_text(json.dumps(
        {"loop": "closed", "clients": 3, "buckets": [1, 2, 4], "bank": 4,
         "warmup_s": 0.05}))
    metric = root / "portbench/metrics/images_served_test.py"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vit_tiny3", "source": "test",
                             "file": "portbench/configs/vit_tiny3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "vit_tiny3.closed3",
                               "config": "vit_tiny3", "traffic": "closed3",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "images_served_test", "unit": "img",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["vit_tiny3.closed3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    metric.write_text(
        'LAYER = "end to end"\nUNIT = "img"\nREADS = "test"\n'
        'MOVES = "images_served_test"\n\n\n'
        'def read(run):\n    return run.completed_in_window\n')
    cell = spec.load_cell("vit_tiny3.closed3", root)
    assert cell.config["sizes"]["layers"] == 3
    assert cell.traffic["clients"] == 3
    assert {m["name"] for m in cell.end_to_end} == {
        "images_served_test", "setup_s"}
    result, compared, run = run_tiny("vit_tiny3.closed3", seconds=0.3)
    assert result["correct"], compared
    assert result["metrics"]["images_served_test"]["value"] == \
        run.completed_in_window > 0
    assert set(result["metrics"]) == {"images_served_test", "setup_s"}


def test_an_unknown_workload_is_refused(tiny_root):
    with pytest.raises(KeyError):
        spec.load_cell("nope", tiny_root)
