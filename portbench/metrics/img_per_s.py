"""Images classified a second: every image completed inside the window,
over the window's whole length."""

LAYER = "end to end"
UNIT = "img/s"
READS = "host clock: each request's completion stamp, the window's bounds"
MOVES = "img_per_s"


def read(run):
    return run.completed_in_window / run.window_s
