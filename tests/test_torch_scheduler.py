"""The rest of serving and the dataset export against the reference: the
scheduler (twins of ``tests/test_dataset_scheduler.py``'s, and every
``Request`` field equal to the reference's on a seeded event stream), the
AzurePublicDataset export (twins, and files byte-identical to the
reference's on the same trace), ``launch.serve.main``'s printed lines
equal to the reference's, and ``launch.train.main`` on the CPU."""
import csv
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.core.dataset_export import export, load_invocations
from repro_torch.core.experiment import FixedSpec, HybridSpec
from repro_torch.core.workload import generate_trace
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.serving.registry import ModelEndpoint, Registry
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.serving.warmpool import WarmPool


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro import configs
        from repro.core import dataset_export, experiment, workload
        from repro.launch import serve
        from repro.serving import registry, scheduler, warmpool
        yield SimpleNamespace(configs=configs, export=dataset_export,
                              E=experiment, workload=workload, serve=serve,
                              registry=registry, scheduler=scheduler,
                              warmpool=warmpool)


def test_export_roundtrip_counts(tmp_path):
    trace = generate_trace(30, days=2.0, seed=9)
    paths = export(trace, str(tmp_path))
    inv_files = [p for p in paths if "invocations" in p]
    assert len(inv_files) == 2      # one per day
    total = sum(load_invocations(p)[1].sum() for p in inv_files)
    assert total == sum(len(t) for t in trace.times)


def test_export_schema(tmp_path):
    paths = export(generate_trace(10, days=1.0, seed=3), str(tmp_path))
    dur = [p for p in paths if "durations" in p][0]
    with open(dur) as f:
        header = next(csv.reader(f))
    assert header[:7] == ["HashOwner", "HashApp", "HashFunction",
                          "Average", "Count", "Minimum", "Maximum"]
    assert "percentile_Average_50" in header
    mem = [p for p in paths if "memory" in p][0]
    with open(mem) as f:
        header = next(csv.reader(f))
    assert "AverageAllocatedMb_pct99" in header


def test_export_byte_identical_to_reference(ref, tmp_path):
    want = ref.export.export(ref.workload.generate_trace(25, days=2.0,
                                                         seed=4),
                             str(tmp_path / "ref"))
    got = export(generate_trace(25, days=2.0, seed=4), str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        with open(g, "rb") as f1, open(w, "rb") as f2:
            assert f1.read() == f2.read(), os.path.basename(g)
    apps, counts = load_invocations(got[0])
    wapps, wcounts = ref.export.load_invocations(want[0])
    assert apps == wapps and np.array_equal(counts, wcounts)


def test_export_needs_an_eager_trace(tmp_path):
    trace = dataclasses.replace(generate_trace(3, days=1.0, seed=1),
                                specs=None)
    with pytest.raises(ValueError, match="eager trace"):
        export(trace, str(tmp_path))


def _mk_pool(policy, m=None):
    """Three reduced SmolLM endpoints behind a warm pool (``m`` the
    reference's serving modules, else the port's)."""
    mods = m or SimpleNamespace(registry=SimpleNamespace(
        Registry=Registry, ModelEndpoint=ModelEndpoint),
        warmpool=SimpleNamespace(WarmPool=WarmPool))
    cfg_mod = m.configs if m is not None else None
    reg = mods.registry.Registry()
    cfg = (cfg_mod.reduced(cfg_mod.get("smollm-135m")) if cfg_mod
           else reduced(get("smollm-135m")))
    for i in range(3):
        reg.register(mods.registry.ModelEndpoint(
            app_id=f"app-{i:06d}", cfg=cfg, seed=i, weight_bytes=int(1e8)))
    return mods.warmpool.WarmPool(reg, policy)


def test_scheduler_batches_bursts():
    sched = Scheduler(_mk_pool(FixedSpec(10.0)), SchedulerConfig(max_batch=4))
    # 8 simultaneous requests to one endpoint -> 2 batches
    done = sched.run(sorted([(1.0, "app-000000", 0.1)] * 8))
    assert len(done) == 8
    assert len({round(r.start_s, 4) for r in done}) == 2
    span = max(r.finish_s for r in done) - min(r.start_s for r in done)
    assert span < 8 * 0.1


def test_scheduler_warm_after_first_batch():
    pool = _mk_pool(FixedSpec(10.0))
    sched = Scheduler(pool, SchedulerConfig(max_batch=2))
    sched.run([(0.0, "app-000001", 0.05)])
    first = sched.completed[0]
    sched.run([(30.0, "app-000001", 0.05)])
    second = sched.completed[1]
    assert (second.start_s - second.arrival_s) < \
        (first.start_s - first.arrival_s)
    assert pool.stats.warm_starts >= 1


def test_scheduler_latency_accounting():
    sched = Scheduler(_mk_pool(HybridSpec(use_arima=False)))
    done = sched.run([(0.0, "app-000002", 0.2), (100.0, "app-000002", 0.2)])
    for r in done:
        assert r.finish_s > r.start_s >= r.arrival_s
        assert r.latency >= r.exec_s


def _events(seed=0, n=400):
    """Bursts and gaps over the three endpoints, sorted by arrival."""
    rng = np.random.default_rng(seed)
    gaps = np.where(rng.uniform(size=n) < 0.3, rng.uniform(0, 0.004, n),
                    rng.exponential(400.0, n))
    t = np.cumsum(gaps)
    apps = rng.integers(0, 3, n)
    exec_s = rng.uniform(0.01, 2.0, n)
    return [(float(a), f"app-{int(b):06d}", float(c))
            for a, b, c in zip(t, apps, exec_s)]


@pytest.mark.parametrize("policy", ["fixed", "hybrid"])
def test_scheduler_equals_reference(ref, policy):
    spec = {"fixed": lambda E: E.FixedSpec(10.0),
            "hybrid": lambda E: E.HybridSpec(use_arima=False)}[policy]
    scfg = dict(max_batch=3, batch_wait_s=0.005, batch_efficiency=0.85)
    events = _events()
    want_pool = _mk_pool(spec(ref.E), ref)
    want = ref.scheduler.Scheduler(
        want_pool, ref.scheduler.SchedulerConfig(**scfg)).run(events)
    got_pool = _mk_pool(spec(SimpleNamespace(FixedSpec=FixedSpec,
                                             HybridSpec=HybridSpec)))
    got = Scheduler(got_pool, SchedulerConfig(**scfg)).run(events)
    assert len(got) == len(want) == len(events)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert g.latency == w.latency
    assert dataclasses.asdict(got_pool.stats) == \
        dataclasses.asdict(want_pool.stats)


@pytest.mark.parametrize("policy", ["hybrid", "fixed"])
def test_launch_serve_prints_the_references_lines(ref, policy, capsys):
    argv = ["--apps", "40", "--minutes", "120", "--policy", policy]
    assert ref.serve.main(argv) == 0
    want = capsys.readouterr().out
    assert serve_cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert serve_cli.main(argv + ["--device", "cpu", "--engine",
                                  "scalar"]) == 0
    assert capsys.readouterr().out == want
    assert want.startswith(f"policy={policy} apps=40 minutes=120\n")


def test_build_registry_counts_like_the_reference(ref):
    want = ref.serve.build_registry(12, seed=3, hbm_budget_bytes=16e9)
    got = serve_cli.build_registry(12, seed=3, hbm_budget_bytes=16e9)
    assert [(e.app_id, e.cfg.arch_id, e.weight_bytes, e.avg_request_s)
            for e in got] == [(e.app_id, e.cfg.arch_id, e.weight_bytes,
                               e.avg_request_s) for e in want]
    with pytest.raises(ValueError):
        serve_cli.make_policy_spec("lru", 10.0)


def test_launch_train_runs_on_the_cpu(capsys):
    assert train_cli.main(["--arch", "smollm-135m", "--reduced", "--steps",
                           "3", "--batch", "2", "--seq", "32",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("[done] loss ")
