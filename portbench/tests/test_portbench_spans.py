"""The readers of the program's ranges (``portbench/spans.py`` and the
metrics ``prefill_idle_share``, ``decode_idle_share``, ``load_busy_share``,
``prefill_launches``, ``pool_self_ms``) on a trace built by hand, the
cases where they have nothing to read, a traced run on the CPU, and on the
card (``gpu``) the shared clock: every attention kernel of a traced run
inside a prefill range."""
import time

import pytest
import torch

from portbench import spans
from portbench import trace as T
from portbench.cell import Cell, RunRecord
from portbench.tests import tiny

# on one clock, in microseconds, a span of 0-100: a decode begun before the
# span (clipped to 0-4), the pool's calls (a tick inside on_request, one
# tick after the span), a load, a prefill, a decode with a capture inside,
# and a prefill that runs past the span (clipped to 95-100)
TR = T.Trace(
    device=[("k", 1, 3),                                  # decode
            ("Memcpy HtoD (Pinned -> Device)", 10, 26),   # load
            ("cast", 24, 28),
            ("flash_attention_hopper_kernel<128>", 32, 40),   # prefill
            ("gemm", 38, 44), ("Memset (Device)", 46, 47),
            ("k", 51, 54),                                # decode
            ("eager_step", 53, 60),                       # capture
            ("replay", 64, 70), ("replay", 70, 80),       # decode
            ("gemm", 96, 99), ("gemm", 99, 105)],         # prefill
    host=[("portbench.window", 0, 100), ("serve.decode", -20, 4),
          ("pool.on_request", 5, 8), ("pool.tick", 6, 7),
          ("serve.load", 10, 30), ("serve.prefill", 30, 50),
          ("aten::mm", 38, 39), ("serve.decode", 50, 90),
          ("serve.capture", 52, 62), ("pool.on_request_end", 92, 94),
          ("serve.prefill", 95, 110), ("pool.tick", 120, 125)],
    span=(0, 100))

NEW = ("prefill_idle_share", "decode_idle_share", "load_busy_share",
       "prefill_launches", "pool_self_ms")


def reader(name):
    return Cell(tiny.BENCH, "qwen2-7b.code-cold").reader(name)


def record(trace, n_traced=2):
    reqs = [dict(index=i, error=None, prompt=128, new=3) for i in range(2)]
    return RunRecord(reqs, n_traced, [], trace, {}, torch.device("cpu"))


def test_ranges_are_clipped_to_the_span():
    assert spans.ranges(TR, "serve.prefill") == [(30, 50), (95, 100)]
    assert spans.ranges(TR, "serve.decode") == [(0, 4), (50, 90)]
    assert spans.ranges(TR, "pool.tick") == [(6, 7)]
    assert spans.without([(0, 4), (50, 90)], [(52, 62)]) == \
        [(0, 4), (50, 52), (62, 90)]
    # busy inside the load: the copy and the cast, 10-28 of 10-30
    assert spans.busy_us(TR, [(10, 30)]) == 18


def test_prefill_readers():
    run = record(TR)
    # busy 32-44 and 46-47 of 30-50, and 96-100 (the last kernel clipped
    # by the span) of 95-100: 17 of 25
    assert reader("prefill_idle_share")(run) == pytest.approx(100 * 8 / 25)
    # three operations start in 30-50, two in 95-100; two ranges
    assert reader("prefill_launches")(run) == pytest.approx(2.5)


def test_decode_reader_cuts_out_the_capture():
    # windows 0-4, 50-52, 62-90 (34 us): busy 1-3, 51-52, 64-80 (19 us);
    # the capture's eager step (53-60) is left out with it
    got = reader("decode_idle_share")(record(TR))
    assert got == pytest.approx(100 * 15 / 34)


def test_load_and_pool_readers():
    run = record(TR)
    assert reader("load_busy_share")(run) == pytest.approx(90.0)
    # pool ranges inside the span: 5-8 (its tick counted once) and 92-94,
    # 5 us over two profiled requests
    assert reader("pool_self_ms")(run) == pytest.approx(5e-3 / 2)


def test_nothing_to_read():
    # no trace, or no profiled request
    assert all(reader(m)(record(None)) is None for m in NEW)
    assert reader("pool_self_ms")(record(TR, n_traced=0)) is None
    # a CPU trace: no device interval; the pool's ranges still read
    cpu = T.Trace([], TR.host, TR.span)
    assert [m for m in NEW if reader(m)(record(cpu)) is not None] == \
        ["pool_self_ms"]
    # a program without the ranges (the benchmark's own spans only)
    bare = T.Trace(TR.device, [("portbench.window", 0, 100),
                               ("portbench.generate", 30, 90)], TR.span)
    assert all(reader(m)(record(bare)) is None for m in NEW)
    # a decode range that is all capture leaves nothing of the decode
    cap = T.Trace(TR.device, [("serve.decode", 50, 62),
                              ("serve.capture", 50, 62)], TR.span)
    assert reader("decode_idle_share")(record(cap)) is None


def test_a_traced_cpu_run_reads_the_pool_alone():
    res = tiny.run("qwen2-7b.code-warm", requests=12, trace=True)
    assert res["correct"], res["checks"]
    got = set(res["metrics"]) & set(NEW)
    assert got == {"pool_self_ms"}
    assert 0 < res["metrics"]["pool_self_ms"]["value"]


@pytest.mark.gpu
def test_attention_kernels_lie_inside_prefill_ranges(monkeypatch):
    """A short traced cell at small sizes on the card (bf16, head dim 64:
    the attention kernel's `hopper` form, prompts in whole 128-token
    tiles): every ``flash_attention_*`` interval of the trace lies inside
    a ``serve.prefill`` range, and the per-phase metrics read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import cell
    seen = []

    def keep(prof, name):
        seen.append(T.from_profiler(prof, name))
        return seen[-1]

    monkeypatch.setattr(cell, "from_profiler", keep)
    workload = "qwen2-7b.code-warm"
    cfg, mix = tiny.cell_files(workload, "bfloat16")
    cfg["model"].update(head_dim=64)
    cfg["prompt_multiple"] = 128
    mix["prompt_tokens"].update(low=128, high=256)
    res = cell.run_cell(tiny.BENCH, workload, tiny.SEED, 0.0, True,
                        device="cuda", t0=time.perf_counter(), config=cfg,
                        traffic=mix, trace_seconds=2.0, requests=16)
    assert res["failed"] == 0
    t = seen[0]
    attn = T.kernels(t, "flash_attention_")
    prefills = spans.ranges(t, "serve.prefill")
    assert attn and prefills
    assert all(any(ps <= s and e <= pe for ps, pe in prefills)
               for _, s, e in attn)
    assert {"prefill_idle_share", "decode_idle_share", "prefill_launches",
            "pool_self_ms"} <= set(res["metrics"])
