"""The device's idle share inside the program's decode ranges, in %: as
``prefill_idle_share`` over the ``serve.decode`` ranges with their
``serve.capture`` children (an entry's first step and its graph's capture)
cut out: the graph's replays (layer: decode)."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    w = spans.without(spans.ranges(t, "serve.decode"),
                      spans.ranges(t, "serve.capture"))
    share = spans.busy_share(t, w)
    return None if share is None else 100.0 * (1.0 - share)
