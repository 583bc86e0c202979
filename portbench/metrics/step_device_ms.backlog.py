"""Device time of one micro-batch: `VisionServer.device_ms` (CUDA events
around each forward, the H2D copy included) over the micro-batches
completed in the window, total over count."""

LAYER = "model step (core/schedule.py)"
UNIT = "ms"
READS = "program span: VisionServer.device_ms"
MOVES = "img_per_s"


def read(run):
    if not run.micro_batch_device_ms:
        return None
    return sum(run.micro_batch_device_ms) / len(run.micro_batch_device_ms)
