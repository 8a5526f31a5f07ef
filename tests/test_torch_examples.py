"""The example twins (``repro_torch.examples``) against the reference
library, on the CPU at tens of apps.

Each twin's printed numbers come from functions the tests call at a small
size: the quickstart's policy points and regime rows, the explorer's
Pareto points, and the exported files equal the reference library's on
the same trace (the points field for field, the files byte for byte). The
serving twin's cold, warm, pre-warm and GB-minute numbers come from the
warm pool, so they are held to the reference's ``WarmPool`` driven by the
same requests (the latencies are measured, not compared). The training
twin's losses depend on the weights' random draw, which the two packages
make differently (the step itself is held to the reference by
``tests/test_torch_training.py``): it is held to the reference script's
configuration, and a run with a crash to the uninterrupted run, bit for
bit. Every twin runs on the card unless told otherwise.
"""
import dataclasses
import filecmp
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.workload import Trace
from repro_torch.examples import (export_dataset, policy_explorer,
                                  quickstart, serve_serverless, train_smollm)

CPU = "cpu"


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
        from repro.core import workload_spec
        from repro.serving import registry, warmpool
        yield SimpleNamespace(configs=configs, export=dataset_export,
                              E=experiment, W=workload, WS=workload_spec,
                              registry=registry, warmpool=warmpool)


def _points(points):
    return [dataclasses.astuple(p) for p in points]


def _ref_grid(ref, specs):
    """The reference's specs of the port's grid (same fields)."""
    kinds = {"FixedSpec": ref.E.FixedSpec, "NoUnloadSpec": ref.E.NoUnloadSpec,
             "HybridSpec": ref.E.HybridSpec}
    return [kinds[type(s).__name__](**dataclasses.asdict(s)) for s in specs]


def test_quickstart_equals_the_reference(ref):
    n_apps, n_inv, points = quickstart.headline(16, days=1.0, device=CPU)
    trace = ref.W.generate_trace(n_apps=16, days=1.0, seed=0)
    want = ref.E.sweep(trace, _ref_grid(ref, quickstart.grid())).points()
    assert (n_apps, n_inv) == (trace.n_apps, sum(len(t) for t in trace.times))
    assert _points(points) == _points(want)
    assert quickstart.headline_lines(n_apps, n_inv, points) == \
        quickstart.headline_lines(n_apps, n_inv, want)

    rows = quickstart.regimes(30, days=1.0, max_events=16, device=CPU)
    scen = [make(30, days=1.0, seed=0, max_events=16)
            for make in (ref.WS.azure_like, ref.WS.bursty,
                         ref.WS.timer_heavy)]
    res = ref.E.sweep(traces=scen, specs=[ref.E.FixedSpec(10.0),
                                          ref.E.HybridSpec(use_arima=False)])
    assert rows == [(res.trace_name(t), res.row(t, 0).cold_pct_percentile(75),
                     res.row(t, 1).cold_pct_percentile(75))
                    for t in range(len(res))]
    assert quickstart.regime_lines(rows)[-1].split()[0] == "timer-heavy-30"


@pytest.mark.parametrize("scenario", [None, "all"])
def test_policy_explorer_equals_the_reference(ref, scenario):
    apps, days = (14, 1.0) if scenario is None else (10, 0.5)
    got = policy_explorer.explore(apps, days, 1, scenario, device=CPU)
    grid = _ref_grid(ref, policy_explorer.build_grid())
    if scenario is None:
        want = [("generate_trace", ref.E.sweep(
            ref.W.generate_trace(apps, days=days, seed=1), grid).points())]
    else:
        specs = [ref.WS.SCENARIOS[n](apps, days=days, seed=1, max_events=64)
                 for n in sorted(ref.WS.SCENARIOS)]
        res = ref.E.sweep(traces=specs, specs=grid)
        want = [(res.trace_name(t), pts)
                for t, pts in enumerate(res.points())]
    assert [t for t, _ in got] == [t for t, _ in want]
    for (title, mine), (_, theirs) in zip(got, want):
        assert _points(mine) == _points(theirs), title
        assert policy_explorer.frontier_lines(mine, title) == \
            policy_explorer.frontier_lines(theirs, title)


def _ref_pool_stats(ref, spec, trace, max_events=150):
    """The reference's WarmPool driven by the requests the reference
    script serves (its drive loop's pool calls)."""
    registry = ref.registry.Registry()
    for i, app in enumerate(trace.specs):
        registry.register(ref.registry.ModelEndpoint(
            app_id=app.app_id, cfg=ref.configs.reduced(ref.configs.get(
                serve_serverless.ARCH_IDS[i % 6])), seed=i,
            weight_bytes=int(50e6)))
    pool = ref.warmpool.WarmPool(registry, spec)
    events = sorted((t * 60.0, app.app_id)
                    for app, ts in zip(trace.specs, trace.times)
                    for t in ts)[:max_events]
    for t, app in events:
        pool.on_request(app, t)
        pool.on_request_end(app, t)
    return pool.finalize(events[-1][0] if events else 0.0)


def test_serve_serverless_equals_the_reference_pool(ref):
    registry, trace = serve_serverless.build(apps=2, minutes=120.0, seed=0)
    assert [ep.cfg.family for ep in registry] == ["dense", "ssm"]
    for spec, rspec in ((serve_serverless.HybridSpec(use_arima=False,
                                                     label="hybrid"),
                         ref.E.HybridSpec(use_arima=False, label="hybrid")),
                        (serve_serverless.FixedSpec(10.0),
                         ref.E.FixedSpec(10.0))):
        stats, cold, warm = serve_serverless.drive(
            spec, trace, registry, device=CPU, max_events=12)
        want = _ref_pool_stats(ref, rspec, trace, max_events=12)
        assert dataclasses.asdict(stats) == dataclasses.asdict(want)
        assert len(cold) == stats.cold_starts
        assert len(warm) == stats.warm_starts
        assert serve_serverless.drive_lines(spec.name, stats, [], [])[0] == \
            serve_serverless.drive_lines(spec.name, want, [], [])[0]


def test_train_smollm_config_is_the_reference_scripts(ref):
    want = ref.configs.get("smollm-135m").with_(
        n_layers=8, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
        d_ff=688, vocab=8192, dtype="float32", remat=False)
    # on the reference's fields (the port's own Nemotron-H fields at their
    # defaults)
    theirs = [f.name for f in dataclasses.fields(want)]
    fields = lambda c: {k: getattr(c, k) for k in theirs}
    for cfg in (train_smollm.config(), train_smollm.config(full=True)):
        assert cfg == type(cfg)(**fields(cfg))
    assert fields(train_smollm.config()) == dataclasses.asdict(want)
    assert fields(train_smollm.config(full=True)) == \
        dataclasses.asdict(ref.configs.get("smollm-135m"))


def test_train_smollm_restart_is_bit_exact(tmp_path):
    kw = dict(steps=7, batch=2, seq=32, device=CPU, checkpoint_every=3,
              log=lambda _: None)
    clean = train_smollm.run(checkpoint_dir=str(tmp_path / "a"), **kw)
    crashed = train_smollm.run(crash_at=5, checkpoint_dir=str(tmp_path / "b"),
                               **kw)
    assert clean["attempts"] == 1 and crashed["attempts"] == 2
    assert crashed["resumed_from"] == 3
    assert crashed["final_loss"] == clean["final_loss"]
    assert crashed["losses"][-4:] == clean["losses"][-4:]
    assert np.isfinite(clean["first_loss"])


def test_export_dataset_equals_the_reference(ref, tmp_path):
    n_inv, paths = export_dataset.export_trace(15, days=1.0,
                                               out=str(tmp_path / "port"))
    trace = ref.W.generate_trace(15, days=1.0, seed=0)
    want = ref.export.export(trace, str(tmp_path / "ref"))
    assert n_inv == sum(len(t) for t in trace.times)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(paths, want):
        assert filecmp.cmp(a, b, shallow=False), a


def test_mains_print_the_reference_lines(capsys, tmp_path):
    policy_explorer.main(["--apps", "10", "--days", "1", "--device", CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "-- generate_trace" and len(out) == 2 + 17
    export_dataset.main(["--apps", "6", "--days", "0.5", "--out",
                         str(tmp_path / "d"), "--device", CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("exported 6 apps / ")
    train_smollm.main(["--steps", "2", "--batch", "2", "--seq", "16",
                       "--checkpoint-dir", str(tmp_path / "ck"),
                       "--device", CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("loss: ") and str(tmp_path / "ck") in out[-1]
    serve_serverless.main(["--apps", "1", "--minutes", "40", "--device",
                           CPU])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("serving 1 endpoints over 40 simulated minutes (real "
                      "model executions)")
    assert out[2].startswith("[hybrid] requests=")
    assert out[-1].startswith("hybrid policy memory saving vs fixed-10m: ")


def test_twins_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    registry, trace = serve_serverless.build(apps=1, minutes=30.0)
    calls = [
        lambda: quickstart.headline(4, days=0.2),
        lambda: policy_explorer.explore(4, 0.2),
        lambda: serve_serverless.drive(serve_serverless.FixedSpec(), trace,
                                       registry),
        lambda: train_smollm.run(steps=1, batch=1, seq=8,
                                 checkpoint_dir=str(tmp_path)),
        lambda: export_dataset.main(["--apps", "2", "--out",
                                     str(tmp_path / "x")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
