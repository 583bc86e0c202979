"""Images a micro-batch held, over the window's requests: the requests
over the micro-batches they rode.  The admission layer picks each group
(its SLA bucket choice, shrunk to fit, and its hold-back while the ring
is busy), and every request of one dispatch carries the same t_start, so
the micro-batches are the distinct t_start stamps."""

LAYER = "admission (launch/admission.py)"
UNIT = "img"
READS = "program span: VisionRequest.t_start of every request"
MOVES = "img_per_s"


def read(run):
    if not run.requests:
        return None
    return len(run.requests) / len({r.t_start for r in run.requests})
