"""Host time of one `VisionServer.dispatch` call (staging the images in
pinned memory, the copy's enqueue, the schedule's launches): the
benchmark's host span around every call in the window, total over
calls."""

LAYER = "server (launch/vision_serve.py)"
UNIT = "ms"
READS = "host clock: the benchmark's span around VisionServer.dispatch"
MOVES = "img_per_s"


def read(run):
    if not run.dispatch_ms:
        return None
    return sum(run.dispatch_ms) / len(run.dispatch_ms)
