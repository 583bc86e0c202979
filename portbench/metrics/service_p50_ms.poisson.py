"""Median service time of the window's requests: from the dispatch of a
request's micro-batch to its completion (t_done - t_start)."""

from harness.window import percentile_ms

LAYER = "server (launch/vision_serve.py)"
UNIT = "ms"
READS = "program span: VisionRequest.t_start and t_done of every request"
MOVES = "img_per_s"


def read(run):
    return percentile_ms([r.service_s for r in run.requests], 50)
