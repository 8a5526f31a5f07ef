"""The device's idle share of the profiled span, in %: 1 - (the union of
its kernel, copy and set intervals) / (the span), both from one trace
(layer: device)."""
from portbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * trace.idle_share(run.trace)
