"""The port's serving slice (``repro_torch.serving``) against the reference's.

  * ``WarmPool``: the warm-pool sequences of ``tests/test_serving.py`` run
    on the port's pool and on the reference's side by side; the returned
    values, ``PoolStats`` and every ``AppState`` must be equal (pure
    Python: exact), and so must the ``state_dict`` and its round trip;
  * ``ServeEngine``: on a reduced hybrid, Mamba-2, Qwen2 (dense, KV
    cache), OLMoE (MoE) and SeamlessM4T (encoder-decoder, its encoder fed
    the frontend stub's zero frames) endpoint whose host weight store is
    filled from the reference engine's ``_weights`` through interop,
    ``generate`` gives the same tokens as the reference's ``ServeEngine``
    (f32 on the CPU, S=128 so both take their kernel branches); ``load``,
    ``unload`` and ``is_loaded`` behave as the reference's do; the device
    copy keeps the ``FP32_AT_USE`` parameters in f32 (the MoE router's
    ``router.w`` among them, not the other ``.w``) and casts the rest to
    the activation dtype;
  * the host store in the served dtypes: an fp32 image handed in (as the
    benchmark's harness hands one) is narrowed at its first load, the
    engine's own draw is stored narrowed, and either gives device weights
    equal bit for bit to ``_placed`` of the fp32 image, the same after a
    reload; an fp32 endpoint's store is left as it was;
  * a reduced Qwen2 endpoint behind the ``WarmPool`` on the CPU, the pool's
    decisions mirrored onto the engine as ``chip_smoke.py`` does: a cold
    start, a warm start, and one engine load per cold start;
  * Qwen2-7B's cost model at full width: 15.2 GB of bf16 weights, a 0.76 s
    cold start.
"""
import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs as port_configs
from repro_torch.core import experiment as port_experiment
from repro_torch.core import policy as port_policy
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import Model
from repro_torch.serving import engine as port_engine
from repro_torch.serving import registry as port_registry
from repro_torch.serving import warmpool as port_warmpool

MIN = 60.0


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro import configs
        from repro.core import experiment, policy
        from repro.serving import engine, registry, warmpool
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=configs,
                              experiment=experiment, policy=policy,
                              engine=engine, registry=registry,
                              warmpool=warmpool)


def _port():
    return SimpleNamespace(configs=port_configs, experiment=port_experiment,
                           policy=port_policy, engine=port_engine,
                           registry=port_registry, warmpool=port_warmpool)


def _registry(m, n=4, weight_bytes=int(1e9)):
    reg = m.registry.Registry()
    cfg = m.configs.reduced(m.configs.get("smollm-135m"))
    for i in range(n):
        reg.register(m.registry.ModelEndpoint(
            app_id=f"app-{i:06d}", cfg=cfg, seed=i, weight_bytes=weight_bytes))
    return reg


# -- the warm-pool sequences of tests/test_serving.py --------------------------


def _fixed_keepalive(m):
    pool = m.warmpool.WarmPool(_registry(m),
                               m.policy.FixedKeepAlivePolicy(10.0))
    seen = [pool.on_request("app-000000", 0.0)]
    pool.on_request_end("app-000000", 1.0)
    seen.append(pool.on_request("app-000000", 1.0 + 5 * MIN))
    pool.on_request_end("app-000000", 1.0 + 5 * MIN)
    seen.append(pool.on_request("app-000000", 1.0 + 5 * MIN + 11 * MIN))
    return pool, seen


def _prewarm_hits(m):
    pool = m.warmpool.WarmPool(_registry(m),
                               m.experiment.HybridSpec(use_arima=False))
    t, seen = 0.0, []
    for _ in range(40):
        seen.append(pool.on_request("app-000000", t))
        pool.on_request_end("app-000000", t + 1.0)
        t += 30 * MIN
    seen.append(dataclasses.asdict(pool.finalize(t)))
    return pool, seen


def _budget_eviction(m):
    pool = m.warmpool.WarmPool(_registry(m), m.experiment.FixedSpec(240.0),
                               budget_bytes=2.5e9)
    seen = []
    for i, t in [(0, 0.0), (1, 60.0), (2, 120.0)]:
        seen.append(pool.on_request(f"app-{i:06d}", t))
        pool.on_request_end(f"app-{i:06d}", t + 1)
    return pool, seen


def _tick_expires_before_prewarming(m):
    pool = m.warmpool.WarmPool(_registry(m, n=2), m.experiment.FixedSpec(10.0),
                               budget_bytes=1e9)
    st_b = pool._st("app-000001")
    seen = [pool.on_request("app-000000", 0.0)]
    pool.on_request_end("app-000000", 0.0)
    pool.state["app-000000"].unload_at = 50.0
    st_b.prewarm_at = 80.0
    pool.tick(100.0)
    return pool, seen


def _tick_prewarms_in_time_order(m):
    pool = m.warmpool.WarmPool(_registry(m, n=2), m.experiment.FixedSpec(10.0),
                               budget_bytes=1e9)
    st_b = pool._st("app-000001")
    st_a = pool._st("app-000000")
    st_b.prewarm_at = 20.0
    st_a.prewarm_at = 10.0
    pool.tick(30.0)
    return pool, []


def _pinned_never_evicted(m):
    pool = m.warmpool.WarmPool(_registry(m, n=2), m.experiment.FixedSpec(10.0),
                               budget_bytes=1.5e9)
    seen = [pool.on_request("app-000000", 0.0)]
    pool._st("app-000001").prewarm_at = 10.0
    pool.tick(20.0)
    seen.append(dataclasses.asdict(pool.state["app-000000"]))
    pool.on_request_end("app-000000", 30.0)
    return pool, seen


def _state_roundtrip(m):
    reg = _registry(m)
    pool = m.warmpool.WarmPool(reg, m.experiment.HybridSpec(use_arima=False))
    t = 0.0
    for _ in range(20):
        pool.on_request("app-000000", t)
        pool.on_request_end("app-000000", t + 1.0)
        t += 15 * MIN
    sd = pool.state_dict()
    pool2 = m.warmpool.WarmPool(reg, m.experiment.HybridSpec(use_arima=False))
    pool2.load_state_dict(sd)
    seen = [sd, pool.on_request("app-000000", t),
            pool2.on_request("app-000000", t)]
    pool2.on_request_end("app-000000", t + 1.0)
    seen.append(pool2.state_dict())
    return pool2, seen


SEQUENCES = {f.__name__.lstrip("_"): f for f in (
    _fixed_keepalive, _prewarm_hits, _budget_eviction,
    _tick_expires_before_prewarming, _tick_prewarms_in_time_order,
    _pinned_never_evicted, _state_roundtrip)}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_warmpool_equals_reference(ref, name):
    want_pool, want_seen = SEQUENCES[name](ref)
    got_pool, got_seen = SEQUENCES[name](_port())
    assert got_seen == want_seen
    assert dataclasses.asdict(got_pool.stats) == \
        dataclasses.asdict(want_pool.stats)
    assert set(got_pool.state) == set(want_pool.state)
    for app, st in want_pool.state.items():
        assert dataclasses.asdict(got_pool.state[app]) == \
            dataclasses.asdict(st), app
    assert got_pool._used == want_pool._used


def test_warmpool_single_image_over_budget_raises(ref):
    for m in (ref, _port()):
        with pytest.raises(ValueError, match="larger than the budget"):
            m.warmpool.WarmPool(_registry(m, n=2, weight_bytes=int(4e9)),
                                m.experiment.FixedSpec(10.0), budget_bytes=2e9)


def test_endpoint_cost_model_equals_reference(ref):
    """Bytes derived from the config (2 x n_params) and the cold-start
    estimate, for the served model at full width."""
    for cached in (False, True):
        want = ref.registry.ModelEndpoint(
            "a", ref.configs.get("recurrentgemma-2b"))
        got = port_registry.ModelEndpoint(
            "a", port_configs.get("recurrentgemma-2b"))
        assert got.weight_bytes == want.weight_bytes
        assert got.cold_start_seconds(cached) == \
            want.cold_start_seconds(cached)


def test_qwen2_cost_model():
    """Qwen2-7B at full width: 2 x 7.62B bf16 bytes, 0.15 s + bytes / 25
    GB/s, as the reference's endpoint gives."""
    ep = port_registry.ModelEndpoint("q", port_configs.get("qwen2-7b"))
    assert ep.weight_bytes == 2 * 7_615_283_200
    assert ep.cold_start_seconds(True) == pytest.approx(0.759, abs=1e-3)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [("recurrentgemma-2b", 5),
                                           ("mamba2-2.7b", 2),
                                           ("qwen2-7b", 2),
                                           ("olmoe-1b-7b", 2),
                                           ("seamless-m4t-medium", 2)])
def test_engine_generates_the_reference_tokens(ref, arch, n_layers):
    S, max_new, app = 128, 6, "app-000000"
    jcfg = ref.configs.reduced(ref.configs.get(arch)).with_(
        n_layers=n_layers, use_kernels=True)
    cfg = port_configs.reduced(port_configs.get(arch)).with_(
        n_layers=n_layers, use_kernels=True)
    jreg, reg = ref.registry.Registry(), port_registry.Registry()
    jreg.register(ref.registry.ModelEndpoint(app, jcfg, seed=7))
    reg.register(port_registry.ModelEndpoint(app, cfg, seed=7))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, S))

    jeng = ref.engine.ServeEngine(jreg)
    jeng.load(app)
    want, _ = jeng.generate(app, ref.jnp.asarray(tokens, ref.jnp.int32),
                            max_new=max_new, max_len=S + max_new)

    eng = port_engine.ServeEngine(reg, device="cpu")
    assert not eng.is_loaded(app)
    eng._weights[app] = model_params_from_numpy(cfg, jeng._weights[app],
                                                device="cpu")
    assert eng.load(app) > 0.0 and eng.is_loaded(app)
    got, seconds = eng.generate(app, torch.from_numpy(tokens),
                                max_new=max_new, max_len=S + max_new)
    # the request's counters: its decode state's bytes and the model's
    # own, the SSD kernel's calls where it has Mamba-2 layers and the
    # gathered-expert kernel's where it has MoE layers
    counters = {"state_bytes"} | set(Model(cfg).counters())
    assert ("ssd_launches" in counters) == (arch == "mamba2-2.7b")
    assert ("expert_gather_launches" in counters) == (arch == "olmoe-1b-7b")
    assert seconds > 0.0 and set(eng.last_times) == {"prefill_s",
                                                     "decode_s"} | counters
    assert got.shape == (2, max_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eng.unload(app)
    assert not eng.is_loaded(app)


def test_engine_load_initialises_once_and_reloads_from_the_host_store():
    app = "app-000000"
    cfg = port_configs.reduced(port_configs.get("recurrentgemma-2b")).with_(
        n_layers=3)
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint(app, cfg, seed=1))
    eng = port_engine.ServeEngine(reg, device="cpu")
    eng.load(app)
    host = eng._weights[app]
    toks = torch.zeros((1, 8), dtype=torch.long)
    first, _ = eng.generate(app, toks, max_new=3)
    eng.unload(app)
    eng.load(app)
    assert eng._weights[app] is host
    again, _ = eng.generate(app, toks, max_new=3)
    assert torch.equal(first, again)


def test_engine_casts_once_at_load_and_keeps_norms_and_lam_fp32():
    app = "app-000000"
    cfg = port_configs.reduced(port_configs.get("recurrentgemma-2b")).with_(
        n_layers=3, dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint(app, cfg, seed=2))
    eng = port_engine.ServeEngine(reg, device="cpu")
    eng.load(app)
    for name, p in eng._loaded[app].named_parameters():
        leaf = name.rpartition(".")[2]
        want = torch.float32 if leaf in ("scale", "lam") else torch.bfloat16
        assert p.dtype == want, name
    loaded = dict(eng._loaded[app].named_parameters())
    for name, p in eng._weights[app].named_parameters():
        assert p.dtype == loaded[name].dtype, name


def test_engine_keeps_the_moe_router_fp32_and_casts_the_experts():
    """The reference routes in f32 on an f32 weight: ``moe.router.w`` stays
    fp32 on the device while every other ``.w`` (attention, head) and the
    stacked experts are cast to bf16; the name rule matches ``router.w``
    by its last two parts only."""
    from repro_torch.models.layers import fp32_at_use
    app = "app-000000"
    cfg = port_configs.reduced(port_configs.get("olmoe-1b-7b")).with_(
        dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint(app, cfg, seed=2))
    eng = port_engine.ServeEngine(reg, device="cpu")
    eng.load(app)
    loaded = dict(eng._loaded[app].named_parameters())
    for i in range(cfg.n_layers):
        assert loaded[f"layers.{i}.moe.router.w"].dtype == torch.float32
        for name in ("moe.wi", "moe.wg", "moe.wo", "attn.wq.w"):
            assert loaded[f"layers.{i}.{name}"].dtype == torch.bfloat16
    assert loaded["head.w"].dtype == torch.bfloat16
    assert loaded["ln_f.scale"].dtype == torch.float32
    assert torch.equal(loaded["layers.0.moe.router.w"],
                       eng._weights[app].layers[0].moe.router.w)
    assert fp32_at_use("router.w") and fp32_at_use("layers.1.moe.router.w")
    assert not fp32_at_use("layers.1.moe.xrouter.w")
    assert not fp32_at_use("layers.1.attn.wo.w")
    assert not fp32_at_use("layers.1.moe.wi")
    # a bf16 endpoint serves: the router's f32 product meets bf16 tokens
    out, _ = eng.generate(app, torch.zeros((1, 8), dtype=torch.long),
                          max_new=2)
    assert out.shape == (1, 2)


def test_engine_draws_the_weights_as_the_endpoint_says():
    """An endpoint's ``init`` reaches ``Model.init``: the host store holds
    the reference draw by default and the ``depth_scaled`` one when the
    endpoint names it, from the same seed."""
    from repro_torch.models import build
    cfg = port_configs.reduced(port_configs.get("olmoe-1b-7b"))
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("ref", cfg, seed=4))
    reg.register(port_registry.ModelEndpoint("deep", cfg, seed=4,
                                             init="depth_scaled"))
    eng = port_engine.ServeEngine(reg, device="cpu")
    for app, scheme in (("ref", "reference"), ("deep", "depth_scaled")):
        eng.load(app)
        want = build(cfg).init(4, device="cpu", scheme=scheme)
        assert all(torch.equal(a, b) for a, b in zip(
            eng._weights[app].parameters(), want.parameters())), app
    assert not torch.equal(eng._weights["ref"].embed.table,
                           eng._weights["deep"].embed.table)


def test_engine_keeps_the_ssm_decay_and_step_bias_fp32():
    """Mamba-2's A_log and dt_bias are f32 at use in the reference (a bf16
    A_log would move every decay rate by up to 0.4%); the norm scales too;
    the rest, D and the conv taps included, is cast to bf16 at load."""
    app = "app-000000"
    cfg = port_configs.reduced(port_configs.get("mamba2-2.7b")).with_(
        dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint(app, cfg, seed=2))
    eng = port_engine.ServeEngine(reg, device="cpu")
    eng.load(app)
    kept = set()
    for name, p in eng._loaded[app].named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("scale", "A_log", "dt_bias"):
            assert p.dtype == torch.float32, name
            kept.add(leaf)
        else:
            assert p.dtype == torch.bfloat16, name
    assert kept == {"scale", "A_log", "dt_bias"}
    host = dict(eng._weights[app].named_parameters())
    assert torch.equal(eng._loaded[app].layers[0].A_log,
                       host["layers.0.A_log"])


def test_engine_frees_the_ssd_scratch_with_its_last_mamba2_app():
    """The SSD scan's scratch (86 MB on the card at Mamba-2's serving
    shape) goes when the last loaded Mamba-2 app unloads, not before, and
    not when another family's app unloads."""
    from repro_torch.kernels import ssd_scan as port_ssd
    ssm = port_configs.reduced(port_configs.get("mamba2-2.7b")).with_(
        n_layers=1)
    rg = port_configs.reduced(port_configs.get("recurrentgemma-2b")).with_(
        n_layers=1)
    reg = port_registry.Registry()
    for app, cfg in (("m0", ssm), ("m1", ssm), ("r0", rg)):
        reg.register(port_registry.ModelEndpoint(app, cfg, seed=3))
    eng = port_engine.ServeEngine(reg, device="cpu")
    for app in ("m0", "m1", "r0"):
        eng.load(app)
    cpu = torch.device("cpu")
    saved = dict(port_ssd._SCRATCH)
    try:
        port_ssd._SCRATCH[cpu] = torch.empty(16, dtype=torch.uint8)
        eng.unload("m0")
        eng.unload("r0")
        assert cpu in port_ssd._SCRATCH      # m1 still runs the scan
        eng.unload("m1")
        assert cpu not in port_ssd._SCRATCH
        eng.unload("m1")                     # not loaded: nothing to do
    finally:
        port_ssd._SCRATCH.clear()
        port_ssd._SCRATCH.update(saved)


def test_dense_endpoint_behind_the_warm_pool():
    """A reduced Qwen2 endpoint (KV cache, ``use_kernels``) served behind
    the hybrid-policy pool on the CPU: the first request is cold and loads
    the weights once, the second, a minute later, is warm and loads
    nothing; each generates the same tokens from the same prompt."""
    cfg = port_configs.reduced(port_configs.get("qwen2-7b")).with_(
        use_kernels=True)
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("q0", cfg, seed=4))
    eng = port_engine.ServeEngine(reg, device="cpu")
    pool = port_warmpool.WarmPool(
        reg, port_experiment.HybridSpec(use_arima=False))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 128)))
    loads, seen = [], []

    def mirror():
        resident = pool.state["q0"].loaded
        if resident and not eng.is_loaded("q0"):
            loads.append(eng.load("q0"))
        elif not resident and eng.is_loaded("q0"):
            eng.unload("q0")

    for minute in (0.0, 1.0):
        now = minute * MIN
        pool.tick(now)
        cold, _ = pool.on_request("q0", now)
        mirror()
        out, _ = eng.generate("q0", toks, max_new=4, max_len=132)
        pool.on_request_end("q0", now)
        mirror()
        seen.append((cold, out))
    assert [c for c, _ in seen] == [True, False]
    assert torch.equal(seen[0][1], seen[1][1])
    assert seen[0][1].shape == (2, 4)
    st = pool.stats
    assert (st.cold_starts, st.warm_starts) == (1, 1)
    assert len(loads) == st.cold_starts + st.prewarms == 1


NARROWED = ["qwen2-7b", "olmoe-1b-7b", "mamba2-2.7b"]


def _bf16_engine(arch, seed=6, device="cpu"):
    cfg = port_configs.reduced(port_configs.get(arch)).with_(
        dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("a", cfg, seed=seed))
    return cfg, port_engine.ServeEngine(reg, device=device)


def _nbytes(params):
    return sum(p.numel() * p.element_size() for p in params.parameters())


def _equal_params(a, b):
    b = dict(b.named_parameters())
    return all(p.dtype == b[n].dtype and torch.equal(p, b[n])
               for n, p in a.named_parameters())


@pytest.mark.parametrize("arch", NARROWED)
def test_engine_narrows_a_handed_in_fp32_image_at_its_first_load(arch):
    """An fp32 image handed in, as the benchmark's harness hands one: the
    first load serves it and narrows the store in place to the served
    dtypes (bf16, the ``fp32_at_use`` leaves fp32); a reload copies those
    bytes, about half, and both loads' device weights equal ``_placed`` of
    the fp32 image bit for bit, with the same tokens."""
    from repro_torch.models.layers import fp32_at_use
    cfg, eng = _bf16_engine(arch)
    image = eng._model(cfg).init(6, device="cpu")
    kept = copy.deepcopy(image)
    eng._weights["a"] = image
    fp32_bytes = _nbytes(image)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 16)))
    eng.load("a")
    assert eng.last_load_bytes == fp32_bytes
    first = copy.deepcopy(eng._loaded["a"])
    before, _ = eng.generate("a", toks, max_new=4)
    assert eng._weights["a"] is image
    for name, p in image.named_parameters():
        want = torch.float32 if fp32_at_use(name) else torch.bfloat16
        assert p.dtype == want, name
    eng.unload("a")
    eng.load("a")
    assert eng.last_load_bytes == _nbytes(image)
    assert 0.45 * fp32_bytes < eng.last_load_bytes < 0.55 * fp32_bytes
    assert _equal_params(eng._loaded["a"], first)
    assert _equal_params(eng._loaded["a"], port_engine._placed(
        kept, torch.device("cpu"), torch.bfloat16))
    after, _ = eng.generate("a", toks, max_new=4)
    assert torch.equal(before, after)


@pytest.mark.parametrize("arch", NARROWED)
def test_engine_stores_its_own_draw_in_the_served_dtypes(arch):
    """The engine's own first-load draw goes to the host already narrowed:
    its device weights equal ``_placed`` of the same fp32 draw bit for bit,
    and every load copies the narrowed store's bytes."""
    cfg, eng = _bf16_engine(arch, seed=8)
    eng.load("a")
    store = eng._weights["a"]
    assert eng.last_load_bytes == _nbytes(store)
    want = port_engine._placed(eng._model(cfg).init(8, device="cpu"),
                               torch.device("cpu"), torch.bfloat16)
    assert _equal_params(eng._loaded["a"], want)
    assert _equal_params(store, want)
    eng.unload("a")
    eng.load("a")
    assert eng._weights["a"] is store
    assert eng.last_load_bytes == _nbytes(store)
    assert _equal_params(eng._loaded["a"], want)


def test_engine_leaves_an_fp32_endpoints_store_as_it_was():
    """An endpoint served in fp32 keeps its fp32 store: the same module,
    the same tensors, the same values, through a load and a reload."""
    cfg = port_configs.reduced(port_configs.get("qwen2-7b"))
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("a", cfg, seed=6))
    eng = port_engine.ServeEngine(reg, device="cpu")
    image = eng._model(cfg).init(6, device="cpu")
    kept = copy.deepcopy(image)
    ptrs = [p.data_ptr() for p in image.parameters()]
    eng._weights["a"] = image
    for _ in range(2):
        eng.load("a")
        eng.unload("a")
    assert eng._weights["a"] is image
    assert [p.data_ptr() for p in image.parameters()] == ptrs
    assert _equal_params(image, kept)
    assert eng.last_load_bytes == _nbytes(kept)


@pytest.mark.gpu
def test_engine_narrowed_store_is_pinned_and_reloads_bit_for_bit():
    """On the card: an fp32 image handed in through ``_to_host`` (pinned,
    as the benchmark's harness makes it) and the engine's own draw both
    end as pinned stores in the served dtypes, half the bytes; a reload
    gives the first load's device weights bit for bit, which equal
    ``_placed`` of the fp32 image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the store is pinned there only")
    dev = torch.device("cuda")
    for arch in NARROWED:
        cfg, eng = _bf16_engine(arch, device=dev)
        image = eng._model(cfg).init(6, device=dev)
        kept = copy.deepcopy(image)
        eng._weights["a"] = port_engine._to_host(image, pin=True)
        fp32_bytes = _nbytes(image)
        eng.load("a")
        first = copy.deepcopy(eng._loaded["a"])
        assert _equal_params(first, port_engine._placed(kept, dev,
                                                        torch.bfloat16))
        eng.unload("a")
        eng.load("a")
        assert 0.45 * fp32_bytes < eng.last_load_bytes < 0.55 * fp32_bytes
        assert _equal_params(eng._loaded["a"], first), arch
        assert all(p.is_pinned() for p in image.parameters()), arch
        eng.unload("a")
        eng._weights.clear()
        eng.load("a")                                # the engine's own draw
        assert all(p.is_pinned() for p in eng._weights["a"].parameters())
        assert _equal_params(eng._loaded["a"], first), arch
        eng.unload("a")


@pytest.mark.parametrize("sizes,chunk,want_chunks", [
    ([1000, 3000, 64], 1 << 32, [4096]),        # a small image: one buffer
    ([40, 40, 40], 128, [128, 64]),             # full chunk, then the tail
    ([100, 300, 50], 256, [256, 300]),          # a larger parameter alone
])
def test_host_layout_sizes_the_last_chunk_to_the_tail(sizes, chunk,
                                                      want_chunks):
    """The engine's pinned host store: chunks of at most ``chunk`` bytes,
    the last one only as large as what is left to place, every view
    64-byte aligned, inside its chunk and apart from every other."""
    chunks, where = port_engine._host_layout(sizes, chunk)
    assert chunks == want_chunks
    spans = sorted((c, off, off + n) for n, (c, off) in zip(sizes, where))
    for (c, lo, hi), nxt in zip(spans, spans[1:] + [None]):
        assert lo % 64 == 0 and hi <= chunks[c]
        if nxt is not None and nxt[0] == c:
            assert hi <= nxt[1]
