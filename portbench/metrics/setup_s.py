"""Set-up: from the process's start to the window's opening (imports,
the libraries' build where missing, weights and images, the server, the
controller's latency probes, the warm-up traffic)."""

LAYER = "end to end"
UNIT = "s"
READS = "host clock: process start and the window's opening"
MOVES = "setup_s"


def read(run):
    return run.setup_s
