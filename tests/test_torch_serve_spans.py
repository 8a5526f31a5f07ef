"""The serve path's profiler ranges (``repro_torch.serving.spans``).

  * with a CPU ``torch.profiler`` running, a tiny engine's ``load``, a
    ``generate`` with three new tokens and a warm pool's three calls leave
    the six CPU ranges by name: ``pool.tick`` inside ``pool.on_request``
    (and once alone), ``serve.load``, then ``serve.prefill`` and
    ``serve.decode`` one after the other inside the ``generate`` call;
  * with no profiler running, ``torch.profiler.record_function`` is never
    entered (replaced by one that raises);
  * the ranges of the source are exactly the seven named ones, none of
    them the benchmark's own (``portbench.*``) or an attention kernel's
    (``flash_attention_*``);
  * on a CUDA card (``gpu``, skipped elsewhere): ``serve.capture`` lies
    inside ``serve.decode`` at the entry's first request only, and the
    kernels of the load, the prefill and the decode inside their ranges,
    to the profiler's clock error (the prompt's copy to the card comes
    before them).
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core.experiment import FixedSpec
from repro_torch.serving import ModelEndpoint, Registry, ServeEngine, \
    WarmPool, spans

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
NAMES = {"pool.tick", "pool.on_request", "pool.on_request_end",
         "serve.load", "serve.prefill", "serve.decode", "serve.capture"}
#: The profiler puts the card's timestamps on the host's clock to within a
#: few microseconds: a prefill's first kernel, launched after its range
#: opened, was seen to start 3.8 us before it (one run in five on an H100).
#: Kernels are held to their phase's range widened by this much at each end.
CLOCK_NS = 20_000


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(device):
    """A tiny Qwen2 endpoint behind a pool: a request's pool calls, its
    load and a ``generate`` of three new tokens, then a second request
    served warm; returns the two outputs."""
    cfg = configs.reduced(configs.get("qwen2-7b")).with_(
        n_layers=2, dtype="bfloat16" if device == "cuda" else "float32")
    reg = Registry()
    reg.register(ModelEndpoint("app-0", cfg, seed=5))
    engine = ServeEngine(reg, device=device)
    pool = WarmPool(reg, FixedSpec(keep_alive=10))
    tokens = torch.arange(16).reshape(1, 16) % cfg.vocab
    outs = []
    for now in (0.0, 1.0):
        pool.tick(now)
        cold, _ = pool.on_request("app-0", now)
        if cold:
            engine.load("app-0")
        with spans.span("generate"):       # the test's own range
            outs.append(engine.generate("app-0", tokens, max_new=3,
                                        max_len=32)[0])
        pool.on_request_end("app-0", now)
    return outs


def _profiled(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        outs = _serve(device)
    events = list(prof.profiler.kineto_results.events())
    iv = lambda e: (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
    on_cpu = lambda e: str(e.device_type()).endswith("CPU")
    host = [iv(e) for e in events if on_cpu(e)]
    names = {n for n, _, _ in host}
    # the device's work: by activity type where the profiler gives one,
    # else every device event that is not a host range's copy
    dev = [iv(e) for e in events if not on_cpu(e) and (
        e.activity_type() in ("kernel", "gpu_memcpy", "gpu_memset")
        if hasattr(e, "activity_type") else e.name() not in names)]
    return outs, host, dev


def _named(host, name):
    return sorted((s, e) for n, s, e in host if n == name)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_the_cpu_ranges_by_name_and_nesting():
    outs, host, _ = _profiled("cpu")
    got = {n for n, _, _ in host} & NAMES
    assert got == NAMES - {"serve.capture"}
    ticks, reqs = _named(host, "pool.tick"), _named(host, "pool.on_request")
    assert len(reqs) == 2 and len(ticks) == 4
    # on_request runs a tick inside its range; the pool's own tick is alone
    assert all(any(_inside(t, r) for t in ticks) for r in reqs)
    assert sum(any(_inside(t, r) for r in reqs) for t in ticks) == 2
    assert len(_named(host, "pool.on_request_end")) == 2
    assert len(_named(host, "serve.load")) == 1       # the second is warm
    gens = _named(host, "generate")
    pre, dec = _named(host, "serve.prefill"), _named(host, "serve.decode")
    assert len(gens) == len(pre) == len(dec) == 2
    for g, p, d in zip(gens, pre, dec):
        assert _inside(p, g) and _inside(d, g) and p[1] <= d[0]
    assert _named(host, "serve.load")[0][1] <= pre[0][0]
    assert torch.equal(outs[0], outs[1])


def test_no_record_function_with_the_profiler_off(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) was entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not torch._C._autograd._profiler_enabled()
    outs = _serve("cpu")
    assert outs[0].shape == (1, 3)
    assert spans.span("serve.load") is spans.span("pool.tick")


def _span_names():
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "id", None) == "span":
                assert isinstance(node.args[0], ast.Constant), path
                yield node.args[0].value


def test_the_seven_names_and_none_of_the_benchmarks():
    names = list(_span_names())
    assert set(names) == NAMES and len(names) == len(NAMES)
    assert not [n for n in names if n.startswith("portbench.")
                or "flash_attention_" in n]


@pytest.mark.gpu
def test_capture_inside_decode_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step's graph is "
                    "captured there only")
    outs, host, dev = _profiled("cuda")
    assert torch.equal(outs[0], outs[1])
    caps = _named(host, "serve.capture")
    pre, dec = _named(host, "serve.prefill"), _named(host, "serve.decode")
    assert len(caps) == 1 and len(dec) == 2
    assert _inside(caps[0], dec[0]) and not _inside(caps[0], dec[1])
    kernels = [(s, e) for n, s, e in dev
               if not n.startswith(("Memcpy", "Memset"))]
    assert kernels
    phases = [(s - CLOCK_NS, e + CLOCK_NS)
              for s, e in pre + dec + _named(host, "serve.load")]
    assert all(any(_inside(k, w) for w in phases) for k in kernels)
