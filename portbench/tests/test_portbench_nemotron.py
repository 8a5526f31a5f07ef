"""The Nemotron-H cell on the CPU at a small size: a sound run is correct,
with the SSD, held-choice and state counters in its requests; a run whose
Mamba-2 layers read the wrong B/C group (the group mapping off by one) is
not; the hybrid stack's operation and byte counts against hand-worked
shapes."""
import json
import time

import pytest
import torch

from portbench import counts, counts_hybrid as CH
from portbench.tests import tiny

CELL = "nemotron-3-nano-30b-a3b.code-warm"


def small_files():
    """The configuration at 6 layers (every kind twice) of width 64: 2 B/C
    groups, 4 of 8 experts held; the code-warm mix at tiny's lengths."""
    cfg = json.loads((tiny.ROOT / "portbench" / "configs" /
                      "nemotron-3-nano-30b-a3b.json").read_text())
    cfg["model"].update(
        layer_pattern="ME*EM*", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, ssm_heads=4, ssm_head_dim=16,
        ssm_groups=2, ssm_state=16, ssm_chunk=16, n_experts=8, top_k=2,
        experts_held=4, d_expert=32, d_shared_expert=48, vocab=512,
        dtype="float32")
    cfg["prompt_multiple"] = 32
    return cfg, tiny.mix("code-warm")


def run(requests=16, trace=False):
    from portbench import cell
    cfg, mix = small_files()
    return cell.run_cell(tiny.BENCH, CELL, tiny.SEED, 0.0, trace,
                         device="cpu", t0=time.perf_counter(), config=cfg,
                         traffic=mix, trace_seconds=1.0, requests=requests)


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] == 16 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "request_p50_s",
                                   "tokens_per_s"}


def test_group_mapping_off_by_one_is_caught(monkeypatch):
    from repro_torch.models import mamba2
    bc = mamba2._bc

    def shifted(cfg, xBC, DI):
        B, C = bc(cfg, xBC, DI)
        return torch.roll(B, 1, dims=-2), torch.roll(C, 1, dims=-2)

    monkeypatch.setattr(mamba2, "_bc", shifted)
    res = run()
    assert not res["correct"]
    assert res["checks"]["logit_gap_mean"]["value"] > \
        res["checks"]["logit_gap_mean"]["limit"]


def test_traced_run_reads_the_counters():
    """A traced run on the CPU: the requests carry ``held_choices`` and
    ``state_bytes`` (no SSD kernel runs there, so ``ssd_launches`` is 0 and
    the SSD readers find nothing); the device metrics have no peaks to read
    against."""
    res = run(requests=6, trace=True)
    assert res["correct"], res["checks"]
    assert "ssd_roofline" not in res["metrics"]
    assert "mfu_hybrid" not in res["metrics"]


def test_ssd_counts_by_hand():
    m = json.loads((tiny.ROOT / "portbench" / "configs" /
                    "nemotron-3-nano-30b-a3b.json").read_text())["model"]
    pairs = 32 * 128 * 129 // 2
    assert CH.ssd_flops(m, 4096) == 2 * 128 * 8 * pairs \
        + 2 * 64 * 64 * pairs + 4 * 4096 * 128 * 64 * 64
    assert CH.ssd_bytes(m, 4096) == 2 * 4096 * 64 * 64 * 2 + 4096 * 64 * 4 \
        + 2 * 4096 * 8 * 128 * 2 + 64 * 128 * 64 * 4
    h100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    least = CH.ssd_least_s(m, 4096, h100)
    assert least == pytest.approx(87_031_808 / 3.35e12)   # bytes bound
    # a short last chunk counts its own pairs
    assert CH.ssd_flops(m, 130) - CH.ssd_flops(m, 128) == \
        (2 * 128 * 8 + 2 * 64 * 64) * 3 + 4 * 2 * 128 * 64 * 64


def test_request_flops_by_hand():
    m = dict(layer_pattern="ME*", d_model=8, head_dim=2, n_heads=4,
             n_kv_heads=2, ssm_heads=2, ssm_head_dim=4, ssm_groups=1,
             ssm_state=3, ssm_chunk=4, conv_width=2, n_experts=8,
             experts_held=4, top_k=2, d_expert=5, d_shared_expert=6,
             vocab=10)
    c = CH.layer_counts(m)
    assert c["mamba"] == 8 * (2 * 8 + 2 * 3 + 2) + 8 * 8
    assert c["conv"] == 2 * (8 + 6)
    assert c["attn"] == 8 * 2 * (4 + 4) + 4 * 2 * 8
    assert c["moe_fixed"] == 8 * 8 + 2 * 8 * 6 and c["expert"] == 2 * 8 * 5
    S = 4
    pre = (2 * (c["mamba"] + c["conv"]) * S + CH.ssd_flops(m, S)
           + 2 * c["attn"] * S + counts.attention_flops(S, 4, 2)
           + 2 * c["moe_fixed"] * S + 3 * 2 * c["expert"] + 2 * 8 * 10)
    assert CH.prefill_flops(m, S, 3) == pre
    dec = (2 * (c["mamba"] + c["conv"]) + 4 * 2 * 3 * 4 + 2 * c["attn"]
           + 4 * 2 * 4 * 5 + 2 * c["moe_fixed"] + 1.0 * 2 * c["expert"]
           + 2 * 8 * 10)
    assert CH.decode_flops(m, 4) == int(dec)
    assert CH.request_flops(m, S, 2, 3) == pre + int(dec)
