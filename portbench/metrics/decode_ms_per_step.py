"""Milliseconds a decode step: the window's ``engine.last_times["decode_s"]``
(graph replays; a capture's seconds are not in it) over its decode steps,
``new - 1`` a request (layer: decode)."""


def read(run):
    reqs = [r for r in run.untraced if r["new"] > 1]
    steps = sum(r["new"] - 1 for r in reqs)
    if not steps:
        return None
    return 1e3 * sum(r["decode_s"] for r in reqs) / steps
