"""The port's HUE CLI (`tools/hue_report_torch.py`) held against the JAX
package's (`tools/hue_report.py`).

  * On ``vit_edge``, float and int8, group 1 and 2, the CLI's reports
    (``--json-out``) have the JAX tool's rows: phase kinds, calls and
    the modelled ms, share and HUE, and its totals.  The measured columns
    are timings and are not compared.
  * ``--fusion-warn`` prints the JAX tool's lines on a synthetic bench
    record and exits 0, and exits 2 on bad JSON.
  * ``--fusion-policy auto`` without ``--fusion-data`` warns and fuses."""

import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


j_tool = _load("hue_report")
t_tool = _load("hue_report_torch")

MODELLED = ("phase", "count", "modelled_cycles", "modelled_ms",
            "modelled_share", "hue_modelled")


@pytest.mark.parametrize("group", [1, 2])
def test_cli_reports_match_jax(group, tmp_path, capsys):
    out = tmp_path / "hue.json"
    rc = t_tool.main(["--models", "vit_edge", "--mode", "both",
                      "--batch", "2", "--warmup", "0", "--repeats", "1",
                      "--fuse-group-size", str(group), "--device", "cpu",
                      "--json-out", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.count("HUEmeas% = modelled MACs") == 2
    record = json.loads(out.read_text())
    assert record["models"] == ["vit_edge"]
    assert record["modes"] == ["float", "int8"]
    assert record["device_count"] == 0          # no card here
    for report in record["reports"]:
        want = j_tool.profile_model("vit_edge", report["mode"], batch=2,
                                    warmup=0, repeats=1, policy=None,
                                    group_size=group)
        for k in ("mode", "batch", "fused", "group_size", "config"):
            assert report[k] == want[k], k
        assert [{k: r[k] for k in MODELLED} for r in report["rows"]] == \
            [{k: r[k] for k in MODELLED} for r in want["rows"]]
        for k in ("boundary_cycles", "boundary_status", "group_size",
                  "launch_cycles_reclaimed", "modelled_cycles", "count"):
            assert report["total"][k] == want["total"][k], k
        assert all(r["measured_ms"] is not None and r["measured_ms"] >= 0
                   for r in report["rows"])


def test_fusion_warn_prints_the_jax_lines(tmp_path, capsys):
    bench = {"runs": [
        {"model": "deit_t", "mode": "float", "batch": 8, "fused": True,
         "fusion_speedup": 0.85, "group_size": 4, "devices": 1},
        {"model": "deit_t", "mode": "int8", "batch": 8, "fused": True,
         "fusion_speedup": 1.2},
        {"model": "swin_t", "mode": "int8", "batch": 2, "fused": True,
         "fusion_speedup": 0.5, "devices": 2},
        {"model": "swin_t", "mode": "int8", "batch": 2, "fused": False,
         "fusion_speedup": 0.5}]}
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    assert j_tool.fusion_warn(str(path)) == 0
    want = capsys.readouterr().out
    assert t_tool.main(["--fusion-warn", str(path)]) == 0
    got = capsys.readouterr().out
    assert got == want and got.count("::warning") == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"runs": []}))
    assert t_tool.main(["--fusion-warn", str(empty)]) == 0
    assert "every fused configuration is a measured win" in \
        capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert t_tool.main(["--fusion-warn", str(bad)]) == t_tool.CRASH_EXIT == 2
    assert "JSONDecodeError" in capsys.readouterr().err


def test_auto_without_fusion_data_warns_and_fuses(capsys):
    assert t_tool.main(["--models", "vit_edge", "--mode", "float",
                        "--batch", "1", "--warmup", "0", "--repeats", "1",
                        "--fusion-policy", "auto", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "no --fusion-data given; 'auto' falls back to the modelled " \
        "default (fuse)" in out
    assert "fused=True" in out
