"""The device's busy share inside the program's load ranges, in %: the
union of copy, kernel and set intervals inside the ``serve.load`` ranges
over their summed length; the ranges close after the load's
synchronisation. Near 100% the bus sets the reload's pace, lower the host
does (layer: engine load)."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    share = spans.busy_share(t, spans.ranges(t, "serve.load"))
    return None if share is None else 100.0 * share
