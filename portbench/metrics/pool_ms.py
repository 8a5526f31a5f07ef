"""Host milliseconds a request spends in the warm pool's calls (``tick``,
``on_request``, ``on_request_end``) and in mirroring them onto the engine,
the engine's loads and unloads left out: the benchmark's own spans around
those calls, averaged over the window's requests outside the profiled part
(layer: warm pool and invoker)."""


def read(run):
    reqs = run.untraced
    if not reqs:
        return None
    return 1e3 * sum(r["pool_s"] for r in reqs) / len(reqs)
