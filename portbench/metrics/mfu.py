"""The whole model step's share of the card's bf16 peak, in %: the model
FLOPs of the profiled requests (``portbench.counts.request_flops``: prefill
and decode, active parameters only, causal attention, logits where the
model computes them) over the profiled span's seconds times the peak
(layer: whole model step)."""
from portbench import counts, trace


def read(run):
    if run.trace is None or run.peaks is None or not run.traced:
        return None
    flops = sum(counts.request_flops(run.model, r["prompt"], r["new"])
                for r in run.traced)
    return 100.0 * flops / (trace.window_s(run.trace)
                            * run.peaks["bf16_flops"])
