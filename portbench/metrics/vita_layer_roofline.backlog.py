"""Kernel 1's share of its roofline: the least time of its calls in the
window (the larger of operations at the TF32 peak and bytes at the HBM
rate, counted from each call's shapes by `harness.counts`) over the
device time of the kernels the calls launched (the profiler's device
side of the benchmark's range around `ops.vita_layer_fused`)."""

from harness.counts import share_pct

LAYER = "kernels (kernels/ops.py + csrc/)"
UNIT = "%"
READS = "device trace: kernels inside the portbench.vita_layer_fused ranges"
MOVES = "img_per_s"


def read(run):
    if not run.layer_least_device_s:
        return None
    least, took = run.layer_least_device_s
    return share_pct(least, took)
