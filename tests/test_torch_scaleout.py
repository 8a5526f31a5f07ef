"""The app-axis scale-out of the port (``repro_torch.distributed.scaleout``,
``EngineOptions(devices=)``, ``run_cluster(devices=)``), on the CPU.

On the CPU an int ``devices=k`` runs ``k`` shards one after another (the
port's counterpart of the reference's forced host devices), so the sharded
path's padding, slicing, per-shard scans and concatenation run here for
``k > 1``. The contract is the reference's: every output equals the
single-device run's bit for bit, for the fixed, SPES and hybrid families
(ARIMA on and off) on the ``fused`` and ``kernel`` engines (the kernel's
plain version here), on every golden trace (24, 32 and 64 apps: two of
them not divisible by 3), and for the cluster engine's phase B. The
port's sharded run also equals the reference's ``devices=1`` run.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import experiment as E
from repro_torch.core.workload_spec import azure_like
from repro_torch.distributed import scaleout
from repro_torch.interop import trace_from_numpy
from repro_torch.serving.cluster_vector import ClusterSpec, run_cluster

GOLDENS = ("bursty_subms_multiweek", "coarse_twoweek", "synthesized_small")
FIELDS = ("cold", "invocations", "wasted_minutes", "final_prewarm",
          "final_keep_alive")


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
        import golden_traces
        from repro.core import experiment
        yield SimpleNamespace(gt=golden_traces, E=experiment)


def _port_trace(t):
    if t.times is not None:
        return trace_from_numpy(t.times, duration_minutes=t.duration_minutes)
    times, counts = t.to_padded()
    return trace_from_numpy(times, counts,
                            duration_minutes=t.duration_minutes)


def _specs(cfg):
    h = cfg.histogram
    hyb = E.HybridSpec(bin_minutes=h.bin_minutes,
                       range_minutes=h.range_minutes,
                       head_percentile=h.head_percentile,
                       tail_percentile=h.tail_percentile, margin=h.margin,
                       cv_threshold=cfg.cv_threshold,
                       min_samples=cfg.min_samples,
                       oob_fraction_threshold=cfg.oob_fraction_threshold,
                       use_arima=False)
    return [E.FixedSpec(10.0), E.NoUnloadSpec(), E.SpesSpec(), hyb,
            dataclasses.replace(hyb, range_minutes=60.0),
            dataclasses.replace(hyb, use_arima=True)]


def _sweep(trace, specs, engine, **opts):
    return E.sweep(trace, specs, engine=engine,
                   options=E.EngineOptions(device="cpu", **opts))


def _assert_rows(got, want, err):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{err}: {f}")


# --------------------------------------------------------------------------
# mesh_for, pad_app_rows, shard_along_apps
# --------------------------------------------------------------------------


def test_mesh_for_on_the_cpu():
    cpu = torch.device("cpu")
    assert scaleout.mesh_for(None, cpu) is None
    assert scaleout.mesh_for("auto", cpu) is None
    assert scaleout.mesh_for(1, cpu) == [cpu]
    assert scaleout.mesh_for(3, "cpu") == [cpu] * 3
    assert scaleout.mesh_for(np.int64(2), cpu) == [cpu] * 2
    for bad in (0, -1, "all", True, 1.5):
        with pytest.raises(ValueError):
            scaleout.mesh_for(bad, cpu)


def test_mesh_for_on_cuda(monkeypatch):
    """CUDA meshes are cuda:0..k-1; past torch.cuda.device_count() the
    request raises naming it; "auto" collapses on one card."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert scaleout.mesh_for(None, cuda) is None
    assert scaleout.mesh_for("auto", cuda) is None
    assert scaleout.mesh_for(1, cuda) == [torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match=r"torch\.cuda\.device_count\(\)"):
        scaleout.mesh_for(2, cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    want = [torch.device("cuda", i) for i in range(3)]
    assert scaleout.mesh_for("auto", "cuda:1") == want
    assert scaleout.mesh_for(3, cuda) == want
    assert scaleout.mesh_for(2, cuda) == want[:2]
    with pytest.raises(RuntimeError, match="is 3"):
        scaleout.mesh_for(4, cuda)


def test_pad_app_rows():
    a = np.arange(10, dtype=np.float32).reshape(5, 2)
    assert scaleout.pad_app_rows(a, 5) is a
    p = scaleout.pad_app_rows(a, 3)
    assert p.shape == (6, 2) and p.dtype == a.dtype
    np.testing.assert_array_equal(p[:5], a)
    assert np.all(np.isposinf(p[5]))
    assert scaleout.pad_app_rows(a, 4, fill=-1.0)[7, 1] == -1.0
    assert scaleout.pad_app_rows(np.zeros((0, 3)), 4).shape == (0, 3)


def test_shard_along_apps_concatenates_in_mesh_order():
    mesh = scaleout.mesh_for(3, "cpu")
    seen = []

    def fn(x, scale, cfg):
        seen.append(x.shape)
        return x * scale + cfg[0], x.sum(0)

    x = torch.arange(24.0).reshape(4, 6)
    cfg = (torch.tensor(1.0), "meta")
    got = scaleout.shard_along_apps(fn, mesh, (1, None, None), -1)(
        x, torch.tensor(2.0), cfg)
    assert seen == [(4, 2)] * 3
    np.testing.assert_array_equal(got[0].numpy(), (x * 2 + 1).numpy())
    np.testing.assert_array_equal(got[1].numpy(), x.sum(0).numpy())
    # pieces already placed, one per device
    parts = list(torch.tensor_split(x, 3, 1))
    got2 = scaleout.shard_along_apps(lambda p: p + 1, mesh, (1,), -1)(parts)
    np.testing.assert_array_equal(got2.numpy(), (x + 1).numpy())
    with pytest.raises(ValueError, match="pad_app_rows"):
        scaleout.shard_along_apps(fn, mesh, (0, None, None), 0)(
            x, torch.tensor(1.0), cfg)
    with pytest.raises(ValueError, match="in_axes"):
        scaleout.shard_along_apps(fn, mesh, (1,), -1)(x, 1.0, cfg)


# --------------------------------------------------------------------------
# The sweep engines
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=GOLDENS)
def golden(request, ref):
    name = request.param
    rtrace = getattr(ref.gt, name)()
    cfg = ref.gt.GOLDEN_TRACES[name][1]
    return name, rtrace, cfg, _port_trace(rtrace), _specs(cfg)


@pytest.mark.parametrize("engine", ["fused", "kernel"])
def test_devices_equal_the_single_device_run(golden, engine):
    name, _, _, trace, specs = golden
    base = _sweep(trace, specs, engine)
    for devices in (1, 3, "auto"):
        got = _sweep(trace, specs, engine, devices=devices)
        for s, spec in enumerate(specs):
            _assert_rows(got.row(s), base.row(s),
                         f"{name} {engine} devices={devices} {spec.name}")


def test_devices_with_chunks_and_an_uneven_app_count():
    """Ragged chunks (app_chunk 7) of a 50-app trace over 3 shards: every
    chunk pads to a multiple of the mesh."""
    trace = azure_like(50, days=1.0, seed=6, max_events=24).materialize()
    specs = [E.FixedSpec(30.0), E.SpesSpec(),
             E.HybridSpec(use_arima=False),
             E.HybridSpec(range_minutes=60.0, use_arima=False)]
    for engine in ("fused", "kernel"):
        base = _sweep(trace, specs, engine, app_chunk=7)
        got = _sweep(trace, specs, engine, app_chunk=7, devices=3)
        for s in range(len(specs)):
            _assert_rows(got.row(s), base.row(s), f"{engine} {s}")


def test_reference_and_scalar_engines_ignore_devices(golden):
    name, _, _, trace, specs = golden
    specs = specs[2:4]
    for engine in ("scalar", "reference"):
        base = _sweep(trace, specs, engine)
        got = _sweep(trace, specs, engine, devices=3)
        for s in range(len(specs)):
            _assert_rows(got.row(s), base.row(s), f"{name} {engine}")


def test_sharded_run_equals_the_reference_devices_1(golden, ref):
    """The port at devices=1 and 3 against the reference's sharded path
    at devices=1 (one host device), for the families whose results the
    two packages share bit for bit (ARIMA off)."""
    name, rtrace, cfg, trace, specs = golden
    specs = specs[:5]
    rspecs = [ref.E.FixedSpec(10.0), ref.E.NoUnloadSpec(), ref.E.SpesSpec(),
              ref.E.HybridSpec.from_config(
                  dataclasses.replace(cfg, use_arima=False)),
              ref.E.HybridSpec.from_config(dataclasses.replace(
                  cfg, use_arima=False,
                  histogram=dataclasses.replace(cfg.histogram,
                                                range_minutes=60.0)))]
    want = ref.E.sweep(rtrace, rspecs, engine="fused",
                       options=ref.E.EngineOptions(devices=1))
    for devices in (1, 3):
        got = _sweep(trace, specs, "kernel", devices=devices)
        for s in range(len(specs)):
            _assert_rows(got.row(s), want.row(s),
                         f"{name} devices={devices} row {s}")


def test_too_many_cards_raise_before_any_work(monkeypatch):
    trace = azure_like(10, days=1.0, seed=1, max_events=8).materialize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="device_count"):
        E.run(trace, E.HybridSpec(use_arima=False), engine="kernel",
              options=E.EngineOptions(device="cuda", devices=2))


# --------------------------------------------------------------------------
# The cluster engine's phase B
# --------------------------------------------------------------------------


def _assert_cluster(got, want, err):
    np.testing.assert_array_equal(got.cold_pct_per_app,
                                  want.cold_pct_per_app, err_msg=err)
    np.testing.assert_array_equal(got.latencies_s, want.latencies_s,
                                  err_msg=err)
    assert got.wasted_gb_minutes == want.wasted_gb_minutes, err
    assert got.stats_per_worker == want.stats_per_worker, err


@pytest.mark.parametrize("spec", [
    E.HybridSpec(use_arima=False), E.SpesSpec(), E.FixedSpec(10.0),
    E.HybridSpec()], ids=lambda s: f"{s.name}-{getattr(s, 'use_arima', 0)}")
def test_run_cluster_devices_equal_none(spec):
    """run_cluster(devices=3) and run(cluster=, EngineOptions(devices=3))
    against devices=None; the ARIMA case on a three-day fleet whose apps
    consult the forecaster."""
    days = 3.0 if getattr(spec, "use_arima", False) else 0.4
    table = azure_like(61, days=days, seed=5, max_events=16)
    cl = ClusterSpec(n_workers=4, hbm_budget_bytes=float("inf"))
    base = run_cluster(table, spec, cl, device="cpu")
    got = run_cluster(table, spec, cl, device="cpu", devices=3)
    _assert_cluster(got, base, "run_cluster devices=3")
    via = E.run(table, spec, cluster=cl,
                options=E.EngineOptions(device="cpu", devices=3))
    _assert_cluster(via, base, "run(cluster=) devices=3")


def test_run_cluster_too_many_cards_raise(monkeypatch):
    table = azure_like(8, days=0.1, seed=1, max_events=4)
    cl = ClusterSpec(n_workers=2, hbm_budget_bytes=float("inf"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for engine in ("auto", "scalar"):
        with pytest.raises(RuntimeError, match="device_count"):
            run_cluster(table, E.FixedSpec(), cl, engine=engine,
                        device="cuda", devices=2)


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_devices_1_equals_none(cuda):
    """The kernel engine's sharded path on one card (one scan launch per
    chunk, band and shard) equals the single-device path bit for bit."""
    from repro_torch.kernels import histogram as H
    trace = azure_like(5_000, days=7.0, seed=2, max_events=64).materialize()
    specs = [E.HybridSpec(use_arima=False), E.FixedSpec(10.0), E.SpesSpec(),
             E.HybridSpec(range_minutes=60.0, use_arima=False)]
    opts = dict(device=cuda, app_chunk=1024)
    base = E.sweep(trace, specs, engine="kernel",
                   options=E.EngineOptions(**opts))
    before = H.SCAN_LAUNCHES
    got = E.sweep(trace, specs, engine="kernel",
                  options=E.EngineOptions(devices=1, **opts))
    assert H.SCAN_LAUNCHES > before
    for s in range(len(specs)):
        _assert_rows(got.row(s), base.row(s), f"card devices=1 row {s}")


@pytest.mark.gpu
def test_card_run_cluster_devices_1_equals_none(cuda):
    table = azure_like(2_000, days=0.5, seed=17, max_events=6)
    cl = ClusterSpec(n_workers=16, hbm_budget_bytes=float("inf"))
    for spec in (E.HybridSpec(use_arima=False), E.SpesSpec()):
        base = run_cluster(table, spec, cl, device=cuda)
        got = run_cluster(table, spec, cl, device=cuda, devices=1)
        _assert_cluster(got, base, f"card run_cluster {spec.name}")
