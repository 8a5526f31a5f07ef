"""The hybrid stack's whole model step's share of the card's bf16 peak, in
%: the model FLOPs of the profiled requests (``portbench.counts_hybrid.
request_flops``: Mamba-2 projections, conv and scan, causal attention in
the attention layers, router, shared expert and routed experts, the routed
work from each prefill's ``last_times["held_choices"]`` and each decode
token's expected held choices, logits where computed) over the profiled
span's seconds times the peak (layer: whole model step)."""
from portbench import counts_hybrid, trace


def read(run):
    if run.trace is None or run.peaks is None or not run.traced or \
            any("held_choices" not in r for r in run.traced):
        return None
    flops = sum(counts_hybrid.request_flops(run.model, r["prompt"], r["new"],
                                            r["held_choices"])
                for r in run.traced)
    return 100.0 * flops / (trace.window_s(run.trace)
                            * run.peaks["bf16_flops"])
