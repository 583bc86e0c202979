"""The check fails a broken timed path: the harness's run on the CPU (its
look for a card skipped), with a fault planted underneath the program's
serving path, reads ``correct`` false; the sound run reads true.  One
case per fault of `harness.faults` (a layer that returns its state
unchanged, half of a micro-batch left out, an answer altered where it is
produced) and the control, the reference in TF32 put in the program's
place.  ``control.py`` plants the same on the card at the cells' sizes."""

from __future__ import annotations

import pytest

from harness import faults

CELLS = ["vit_tiny.backlog", "swin_tiny.backlog", "vit_tiny.poisson"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_run_is_correct(run_tiny, workload):
    result, compared, _ = run_tiny(workload)
    assert result["correct"], compared


def test_a_planted_fault_is_taken_out_after_its_block(tiny_root):
    from repro_torch.kernels import ops
    from repro_torch.launch.vision_serve import VisionServer
    from harness import spec
    config = spec.load_cell("swin_tiny.backlog", tiny_root).config
    before = (ops.vita_layer_fused, VisionServer.forward,
              VisionServer.complete)
    for fault in faults.FAULTS:
        with faults.planted(fault, config):
            pass
    assert (ops.vita_layer_fused, VisionServer.forward,
            VisionServer.complete) == before


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_reads_not_correct(run_tiny, tiny_root, workload, fault):
    from harness import spec
    config = spec.load_cell(workload, tiny_root).config
    with faults.planted(fault, config):
        result, compared, _ = run_tiny(workload)
    assert not result["correct"], compared
    value, limit = compared["logit_gap"]
    assert value > limit
