"""The import rule: no JAX and no JAX package, names compared by their
whole top-level name; the reference imports nothing of the program."""

from __future__ import annotations

import subprocess
import sys

from conftest import BENCH, ROOT
from harness import guard


def test_top_level_names_are_compared_whole():
    loaded = ["repro_torch", "repro_torch.kernels.ops", "jaxtyping",
              "reproduce", "repro", "repro.kernels", "jax.numpy", "jaxlib",
              "flax.linen", "torch"]
    assert guard.loaded_forbidden(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.kernels"]


def test_the_reference_imports_nothing_forbidden():
    assert guard.reference_violations(BENCH / "reference") == []


def test_a_reference_that_imports_the_program_is_caught(tmp_path):
    (tmp_path / "bad.py").write_text(
        "import torch\nfrom repro_torch.kernels import ref\n"
        "from . import common\n")
    assert guard.reference_violations(tmp_path) == [
        "bad.py: repro_torch.kernels"]


def test_the_serving_path_loads_no_jax():
    """Import what a run imports, the program's serving path included,
    in a fresh process: nothing forbidden is loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import program\n"
        "import repro_torch.launch.admission, repro_torch.launch.vision_serve\n"
        "import repro_torch.models.vit, repro_torch.models.swin\n"
        "from harness import guard\n"
        "print(guard.loaded_forbidden(sys.modules))\n"
    ) % (str(ROOT / "src"), str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
