"""The SSD scan kernel's share of its roofline, in %: the least time of
every call in the profiled requests (``portbench.counts_hybrid``: the larger
of its bytes at the HBM peak and its operations at the bf16 peak, at its
prompt's length) over the device time of the ``ssd_`` kernels in the trace.
A call is one ``ssd_out`` kernel (after ``ssd_states``); where the trace
holds another number of calls than the requests' own counter
(``last_times["ssd_launches"]``, one a Mamba-2 layer a prefill), nothing is
read (layer: SSD scan kernel)."""
from portbench import counts_hybrid, trace

NEEDLE = "ssd_"


def read(run):
    if run.trace is None or run.peaks is None or not run.traced:
        return None
    calls = [r.get("ssd_launches", 0) for r in run.traced]
    ks = trace.kernels(run.trace, NEEDLE)
    if not sum(calls) or sum("ssd_out" in k[0] for k in ks) != sum(calls):
        return None
    device_s = sum(e - s for _, s, e in ks) / 1e6
    least = sum(n * counts_hybrid.ssd_least_s(run.model, r["prompt"],
                                              run.peaks)
                for n, r in zip(calls, run.traced))
    return 100.0 * least / device_s if device_s > 0 else None
