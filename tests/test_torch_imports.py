"""Import hygiene of the port: no module of `repro_torch`, and not
chip_smoke.py, imports JAX or the JAX package (and importing them needs
neither nvcc nor a card); chip_smoke.py refuses to run without a card
or without the sources beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = _CHECK.format(src=str(ROOT / "src"),
                         smoke=str(ROOT / "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 40          # with the LM slice: configs, models, steps
    assert bad == "[]", bad


def test_chip_smoke_fails_without_a_card_or_sources(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for where, script in ((ROOT, ROOT / "chip_smoke.py"),
                          (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=300,
                             env=_env(), cwd=where)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


_TOOLS = r"""
import importlib.util, sys
sys.path.insert(0, {src!r})
for path in {paths!r}:
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len({paths!r}), bad)
"""


def test_port_tools_and_examples_import_neither_jax_nor_repro():
    paths = [str(ROOT / "tools" / "hue_report_torch.py")] + sorted(
        str(p) for p in (ROOT / "examples").glob("*_torch.py"))
    code = _TOOLS.format(src=str(ROOT / "src"), paths=paths)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=_env(), cwd=ROOT)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) == 4 and bad == "[]", out.stdout
