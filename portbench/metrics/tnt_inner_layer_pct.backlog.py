"""TNT's inner stream's share of kernel 1's device time: the device time
of the inner stream's kernel-1 ranges over that of every kernel-1 range
in the window (`harness.trace.reduce`'s ``layer_device_s``).

Which range is the inner stream's: a TNT layer calls kernel 1 on the
inner stream (N the pixel tokens of a patch) and then on the outer
stream, and no other call comes between, so counted from the first call
after the benchmark's span went in, the inner calls are the even ones.
A range is inner where its index among all calls (``layer_calls``) is
even.  None where the window has no kernel-1 range."""

LAYER = "kernels (kernels/ops.py + csrc/)"
UNIT = "%"
READS = "device trace: kernels inside the portbench.vita_layer_fused ranges of even call index, over all of them"
MOVES = "img_per_s"


def read(run):
    s = run.summary
    if s is None or not s.layer_device_s:
        return None
    total = sum(s.layer_device_s)
    if total <= 0:
        return None
    inner = sum(t for t, i in zip(s.layer_device_s, s.layer_calls)
                if i % 2 == 0)
    return 100.0 * inner / total
