"""The share of the traced window in which no kernel, copy or set ran on
the device: one minus the union of the profiler's device intervals over
the window's length."""

LAYER = "device"
UNIT = "%"
READS = "device trace: the union of kernel, copy and set intervals"
MOVES = "img_per_s"


def read(run):
    if run.summary is None:
        return None
    return run.summary.idle_pct
