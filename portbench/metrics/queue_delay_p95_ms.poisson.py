"""95th percentile of the time each request of the window waited before
its micro-batch was dispatched (t_start - t_submit, the program's own
stamps; t_submit is the due time)."""

from harness.window import percentile_ms

LAYER = "admission (launch/admission.py)"
UNIT = "ms"
READS = "program span: VisionRequest.t_submit and t_start of every request"
MOVES = "img_per_s"


def read(run):
    return percentile_ms([r.queue_s for r in run.requests], 95)
