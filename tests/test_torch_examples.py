"""The port's three examples run on the CPU at a small size:
`examples/quickstart_torch.py` (the perfmodel line, the demo ViT's int8
PTQ, the kernels' plain versions), `examples/serve_quantized_vit_torch.py`
(AdamW steps through `vit.forward`'s gradient, PTQ, float and int8
`VisionServer` drains) and `examples/train_lm_torch.py` (``--small``
through `launch.train`, and the ``build_config`` override of
`_run_custom` on a tiny config)."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_cpu(capsys):
    out = _load("quickstart_torch").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "ViT-B/16@256 on ViTA" in printed and printed.endswith("done.\n")
    assert out["argmax_match"] and out["ptq_err"] < 0.5
    assert out["mlp_err"] == 0.0 and out["attention_err"] == 0.0


def test_serve_quantized_vit_trains_and_serves(capsys):
    out = _load("serve_quantized_vit_torch").main(
        ["--device", "cpu"], steps=6, batch=8, serve_batches=1)
    assert len(out["losses"]) == 6
    assert out["losses"][-1] < out["losses"][0]
    for mode in ("float", "int8"):
        assert out["stats"][mode]["requests"] == 8
    assert 0.0 <= out["agreement"] <= 1.0
    assert "[vita-model]" in capsys.readouterr().out


def test_train_lm_small_and_custom(tmp_path):
    ex = _load("train_lm_torch")
    hist = ex.main(["--small", "--steps", "3", "--device", "cpu",
                    "--ckpt", str(tmp_path / "small")])
    assert [h["step"] for h in hist] == [0, 2]
    tiny = dataclasses.replace(ex.lm_100m(), n_layers=2, d_model=64,
                               n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128, vocab=256, window=32)

    class Args:
        steps = 2
        ckpt = str(tmp_path / "custom")

    hist = ex._run_custom(tiny, Args, ["--device", "cpu"])
    assert len(hist) == 2 and all(h["loss"] > 0 for h in hist)
    assert ex.train_mod.build_config.__name__ == "build_config"
    assert os.listdir(tmp_path / "custom")


def test_examples_refuse_without_a_card():
    """The card is the default device: without one the example says how
    to run on the CPU and exits non-zero."""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "quickstart_torch.py")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                 CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
