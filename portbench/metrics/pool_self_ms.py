"""Host milliseconds a request inside the warm pool's own calls: the
union of the program's ``pool.tick``, ``pool.on_request`` and
``pool.on_request_end`` ranges in the profiled span (a tick inside
``on_request`` counted once), over the profiled requests (layer: warm pool
and invoker)."""
from portbench import spans


def read(run):
    t = run.trace
    if t is None or not run.traced:
        return None
    us = spans.host_us(t, "pool.")
    return us / 1e3 / len(run.traced) if us > 0 else None
