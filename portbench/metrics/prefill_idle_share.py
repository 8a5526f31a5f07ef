"""The device's idle share inside the program's prefill ranges, in %:
1 - (the union of kernel, copy and set intervals inside the
``serve.prefill`` ranges) / (their summed length), one trace; the ranges
close after the prefill's synchronisation, so its device work lies inside
(layer: prefill)."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    share = spans.busy_share(t, spans.ranges(t, "serve.prefill"))
    return None if share is None else 100.0 * (1.0 - share)
