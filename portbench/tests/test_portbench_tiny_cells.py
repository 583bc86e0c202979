"""The tests that drive conftest's tiny cells, run again on a checkout
built from BENCHMARK.json less the cells that have no tiny stand-in.

`conftest.write_tiny_root` maps every name in a metric's ``workloads``
through its own table of the three cells it stands in for (DeiT-S's and
Swin-T's), so with ``tnt_s.fp32.backlog`` listed it raises KeyError and
the tests below error where their own modules collect them.  Here
`tiny_root` hands `write_tiny_root` a BENCHMARK.json whose lists keep
only the cells of the configurations `conftest.TINY_SIZES` copies (a
metric left with none is dropped), which is the benchmark those tests
were written against.  Once `write_tiny_root` skips the names it has no
stand-in for, this module has nothing left to do and goes.  The tiny
TNT cell is `test_portbench_tnt`'s."""

from __future__ import annotations

import json

import pytest

import conftest
from test_portbench_faults import (  # noqa: F401
    test_a_fault_reads_not_correct,
    test_a_planted_fault_is_taken_out_after_its_block,
    test_the_sound_run_is_correct)
from test_portbench_files import (  # noqa: F401
    test_a_new_config_traffic_and_metric_are_found_by_name,
    test_an_unknown_workload_is_refused)
from test_portbench_output import (  # noqa: F401
    test_a_cpu_run_reports_its_cells_end_to_end_metrics,
    test_a_traced_run_without_device_time_fails,
    test_per_layer_readers_read_a_traced_record)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    bench = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
    bases = {base for base, _ in conftest.TINY_SIZES.values()}
    known = {w["name"] for w in bench["workloads"] if w["config"] in bases}
    for key in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[key]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w in known]
                if not m["workloads"]:
                    continue
            kept.append(m)
        bench[key] = kept
    source = tmp_path / "source"
    source.mkdir()
    (source / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(conftest, "ROOT", source)
    return conftest.write_tiny_root(tmp_path / "checkout")
