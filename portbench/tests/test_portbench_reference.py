"""The frozen reference against the port's own CPU forward, and its
control (one precision below) against the limits."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from conftest import BENCH
from harness import check
from reference import common
from reference import swin as ref_swin
from reference import vit as ref_vit

# The registry's reduced geometries: DeiT-T's widths at depth 4 and 64 px,
# and Swin's two-stage 56 px variant (shifted windows, one merge).
CASES = [("deit_t", ref_vit, "deit_s"), ("swin_t", ref_swin, "swin_t")]


def _port(name):
    from repro_torch.models import swin, vision_registry, vit
    cfg = vision_registry.build_cfg(name)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    mod = swin if isinstance(cfg, swin.SwinConfig) else vit
    return cfg, fields, mod


def _limit(config: str) -> float:
    return json.loads((BENCH / "configs" / f"{config}.json").read_text()
                      )["limits"]["logit_gap"]


@pytest.mark.parametrize("name,ref,config", CASES)
def test_reference_matches_the_port_on_cpu(name, ref, config):
    cfg, sizes, mod = _port(name)
    params = common.make_tree(ref.leaves(sizes), 2 ** 31 + 3, "cpu")
    images = common.images(2 ** 31 + 3, 4, cfg.image, "cpu")
    want = ref.forward(params, images, sizes).double().numpy()
    from repro_torch.models import vit
    got = mod.forward(params, vit.extract_patches(images, cfg.patch),
                      cfg).double().numpy()
    gaps = check.row_gaps(got, want)
    assert gaps.max() < _limit(config) / 10, gaps


@pytest.mark.parametrize("name,ref,config", CASES)
def test_control_fails_the_limit(name, ref, config):
    """The control, the reference in TF32 (emulated on the CPU: operands
    rounded to 10 mantissa bits), reads above the configuration's limit."""
    _, sizes, _ = _port(name)
    for seed in (1, 2, 3):
        params = common.make_tree(ref.leaves(sizes), seed, "cpu")
        images = common.images(seed, 4, sizes["image"], "cpu")
        want = ref.forward(params, images, sizes, "fp32").double().numpy()
        ctl = ref.forward(params, images, sizes, "tf32").double().numpy()
        assert check.row_gaps(ctl, want).max() > _limit(config)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0], dtype=torch.float32)
    got = common.round_tf32(x).tolist()
    # 1 + 2^-11 is a tie and goes to even (1.0); 1 + 3 * 2^-11 to 1 + 2^-9
    assert got == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0, 3.0]


def test_weights_and_images_follow_the_seed():
    leaves = ref_vit.leaves({"image": 32, "patch": 8, "dim": 64, "heads": 2,
                             "layers": 1, "mlp_ratio": 4.0, "n_classes": 10})
    a = common.make_tree(leaves, 2 ** 31 + 7, "cpu")
    b = common.make_tree(leaves, 2 ** 31 + 7, "cpu")
    c = common.make_tree(leaves, 2 ** 31 + 8, "cpu")
    assert torch.equal(a["layers"][0]["wq"], b["layers"][0]["wq"])
    assert not torch.equal(a["layers"][0]["wq"], c["layers"][0]["wq"])
    assert a["layers"][0]["wq"].shape == (2, 64, 32)
    # weights and images draw different streams of one seed
    assert common.derive(2 ** 31 + 7, "weights") != \
        common.derive(2 ** 31 + 7, "images")
