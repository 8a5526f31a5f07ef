"""The trace reduction on synthetic traces: overlapping kernels and copies,
gaps named by the host's ranges, and the readers of the traced metrics."""
import pytest
import torch

from portbench import trace as T
from portbench.cell import RunRecord
from portbench.tests import tiny

# on one clock, in microseconds: a span of 100; kernels at 0-10 and 5-20
# (overlapping), a copy at 30-40 under a kernel at 35-50, a set at 90-95
TR = T.Trace(
    device=[("gemm_kernel", 0, 10), ("flash_attention_hopper_kernel<128>", 5,
                                     20),
            ("Memcpy HtoD (Pinned -> Device)", 30, 40), ("gemm_kernel", 35,
                                                         50),
            ("Memset (Device)", 90, 95), ("late_kernel", 120, 130)],
    host=[("portbench.window", 0, 100), ("portbench.generate", 0, 60),
          ("aten::mm", 22, 28), ("portbench.pool", 60, 100),
          ("cudaStreamSynchronize", 50, 60)],
    span=(0, 100))


def test_union_and_idle_share():
    # busy: [0, 20] + [30, 50] + [90, 95] = 45 us, the late kernel outside
    assert T.union_us(TR.device, TR.span) == 45
    assert T.busy_s(TR) == pytest.approx(45e-6)
    assert T.window_s(TR) == pytest.approx(100e-6)
    assert T.idle_share(TR) == pytest.approx(0.55)


def test_idle_gaps_by_host_range():
    gaps = dict((k, v) for k, v in T.idle_gaps(TR))
    # 20-30 inside generate and aten::mm; the gap 50-90 cut where generate
    # ends: 50-60 inside generate and the sync, 60-90 inside pool; 95-100
    # inside pool
    assert gaps == pytest.approx({
        "portbench.generate > aten::mm": 10e-6,
        "portbench.generate > cudaStreamSynchronize": 10e-6,
        "portbench.pool": 35e-6})


def test_device_ops_and_kernels():
    ops = T.device_ops(TR)
    assert ops[0] == ["gemm_kernel", pytest.approx(25e-6)]
    assert [k[0] for k in T.kernels(TR, "flash_attention_")] == \
        ["flash_attention_hopper_kernel<128>"]


MODEL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
             d_ff=512, vocab=100)


def record(prompts, trace):
    reqs = [dict(index=i, error=None, prompt=S, new=3, prefill_s=0.1,
                 decode_s=0.02, pool_s=0.001) for i, S in enumerate(prompts)]
    run = RunRecord(reqs, len(reqs), [], trace, MODEL, torch.device("cpu"))
    run.peaks = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e12}
    return run


def test_attn_roofline_reads_every_launch():
    from portbench.cell import Cell
    read = Cell(tiny.BENCH, "qwen2-7b.code-warm").reader("attn_roofline")
    S = 256
    launches = [(f"flash_attention_hopper_kernel<128>", 10.0 * i,
                 10.0 * i + 4.0) for i in range(4)]          # 4 us each
    t = T.Trace(launches, [], (0, 100))
    least = max(2 * 128 * 2 * S * (S + 1) / 1e12,
                (2 * 2 + 2 * 1) * S * 128 * 2 / 1e12)
    got = read(record([S, S], t))                   # 2 layers x 2 prefills
    assert got == pytest.approx(100 * 4 * least / 16e-6)
    # another number of launches than layers x prefills: nothing to read
    assert read(record([S], t)) is None
    assert read(record([S, S], None)) is None


def test_mfu_and_idle_share_readers():
    from portbench import counts
    from portbench.cell import Cell
    c = Cell(tiny.BENCH, "qwen2-7b.code-warm")
    run = record([128, 256], TR)
    want = 100 * (counts.request_flops(MODEL, 128, 3)
                  + counts.request_flops(MODEL, 256, 3)) / (100e-6 * 1e12)
    assert c.reader("mfu")(run) == pytest.approx(want)
    assert c.reader("idle_share")(run) == pytest.approx(55.0)
    assert c.reader("decode_ms_per_step")(run) == pytest.approx(10.0)
    assert c.reader("prefill_tokens_per_s")(run) == pytest.approx(1920.0)
    assert c.reader("pool_ms")(run) == pytest.approx(1.0)
    run.peaks = None
    assert c.reader("mfu")(run) is None


def test_tokens_per_s_counts_the_window_share_of_the_last_request():
    from portbench.cell import _tokens_per_s
    done = [dict(start=0.0, done=4.0, prompt=90, new=10),
            dict(start=4.0, done=8.0, prompt=390, new=10),
            dict(start=8.0, done=12.0, prompt=190, new=10)]
    # a window of 10 s: all of the first two, half of the third
    assert _tokens_per_s(done, 0.0, 10.0) == pytest.approx(600 / 10)
    # no window length (a fixed number of requests): all of them
    assert _tokens_per_s(done, 0.0, None) == pytest.approx(700 / 12)
