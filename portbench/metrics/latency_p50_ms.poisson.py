"""Median latency of every request due in the window, from its due time
to its completion (the queued ones drained after arrivals stop count)."""

from harness.window import percentile_ms

LAYER = "admission (launch/admission.py)"
UNIT = "ms"
READS = "program span: each request's due time and VisionRequest.t_done"
MOVES = "img_per_s"


def read(run):
    return percentile_ms([r.latency_s for r in run.requests], 50)
