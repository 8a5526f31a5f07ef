"""Device operations a prefill: the kernel, copy and set intervals that
start inside a ``serve.prefill`` range, over the number of such ranges in
the profiled span; what a prefill graph or fused routing would cut
(layer: prefill)."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    w = spans.ranges(t, "serve.prefill")
    if not w:
        return None
    return spans.starts_inside(t, w) / len(w)
