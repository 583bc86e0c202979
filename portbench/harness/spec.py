"""Find a cell's files by name.

`BENCHMARK.json` names each cell's configuration, traffic mix and
metrics; everything that belongs to one of them is a file of its own:

* ``configs/<config>.json``: the configuration (sizes, source, the
  program's config class, the libraries its path builds, the limits of
  the correctness check);
* ``traffic/<traffic>.json``: the traffic mix's parameters
  (`harness.traffic` reads them);
* ``metrics/<metric>.py``: one reader per metric, end-to-end or
  per-layer (`load_metric`).

So a new configuration, traffic mix or metric is a new file and a new
entry in `BENCHMARK.json`, and no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]       # portbench/
ROOT = BENCH_DIR.parent                               # the checkout


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    root: Path
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``workload`` of ``root``'s `BENCHMARK.json`, with its
    configuration and traffic files read and its metrics selected: an
    entry with a ``workloads`` list applies to those cells, one without
    to every cell."""
    root = Path(root)
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name=workload, root=root, chips=int(w["chips"]),
                config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py`` as a module: ``LAYER``, ``UNIT``, ``READS``,
    ``MOVES`` and ``read(run) -> float | None`` (None: nothing to read in
    this run, and the metric is left out of the line)."""
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("LAYER", "UNIT", "READS", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric file {path} lacks {attr}")
    return mod


def load_reference(family: str) -> ModuleType:
    """``reference/<family>.py``: ``leaves(sizes)`` and ``forward(params,
    images, sizes, mode)``."""
    return importlib.import_module(f"reference.{family}")
