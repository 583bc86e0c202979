"""The whole step's share of the chip's peak: the configuration's
operations an image times the images completed in the window, over the
window, over the TF32 dense peak (the fastest tensor-core route for
float32 operands)."""

from harness.counts import TF32_FLOP_S

LAYER = "model step (core/schedule.py)"
UNIT = "%"
READS = "host clock: images completed in the window; the configuration's flops_per_image"
MOVES = "img_per_s"


def read(run):
    if run.completed_in_window == 0:
        return None
    return 100.0 * run.flops_per_image * run.completed_in_window \
        / run.window_s / TF32_FLOP_S
