"""The SSD scan kernel's share of the prefill's device time, in %: the
union of the ``ssd_`` kernels' intervals inside the program's
``serve.prefill`` ranges over the union of all device intervals there
(layer: SSD scan kernel)."""
from portbench import spans, trace


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    w = spans.ranges(t, "serve.prefill")
    busy = spans.busy_us(t, w)
    ssd = trace.kernels(t, "ssd_")
    if not w or busy <= 0 or not ssd:
        return None
    mine = spans.busy_us(trace.Trace(ssd, t.host, t.span), w)
    return 100.0 * mine / busy
