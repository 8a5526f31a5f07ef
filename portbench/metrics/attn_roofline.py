"""The prefill attention kernel's share of its roofline, in %: the least
time of every launch in the profiled requests (``portbench.counts``, from
each prompt's length and the model's heads) over the kernel's device time
in the trace (kernels named ``flash_attention_*``). Each prefill launches
the kernel once a layer; where the trace holds another number of launches
than that, or than the program's own counter
(``flash_attention.LAUNCHES``), nothing is read (layer: attention
kernel)."""
from portbench import counts, trace

NEEDLE = "flash_attention_"


def read(run):
    if run.trace is None or run.peaks is None or not run.traced:
        return None
    m = run.model
    launches = trace.kernels(run.trace, NEEDLE)
    if len(launches) != m["n_layers"] * len(run.traced) or \
            run.launches.get("flash_attention", len(launches)) != len(launches):
        return None
    device_s = sum(e - s for _, s, e in launches) / 1e6
    least = sum(m["n_layers"] * counts.attention_least_s(
        r["prompt"], m["n_heads"], m["n_kv_heads"], m["head_dim"], run.peaks)
        for r in run.traced)
    return 100.0 * least / device_s if device_s > 0 else None
