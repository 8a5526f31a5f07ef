"""The port's MoE family (``repro_torch.models.moe``) end to end against the
reference's, on the same weights.

Configs: ``reduced(get("olmoe-1b-7b"))`` (2 layers, d_model 128, 4 heads of
32 as MHA, 8 experts of 64, top 2, groups of 64 tokens) and
``reduced(get("qwen3-moe-30b-a3b"))`` (the same with 4 q heads over 2 KV
heads). The weights come from the reference's ``Model.init`` and cross
through ``interop.model_params_from_numpy``.

  * For ``use_kernels`` False and True, at S = 24 (one group of 48 tokens)
    and 128 (four groups of 64; the prefill's kernel condition):
    ``forward`` (logits and aux), ``prefill``'s last-token logits and its
    KV cache, and four teacher-forced ``decode_step``s (one group of 2
    tokens, capacity 1), in f32 within atol = rtol = 1e-4.
  * The routing exactly: ``_route``'s ``topi``, ``positions``, ``keep``
    and ``C`` equal the reference's, ``topv`` and the aux loss within 1e-6,
    on seeded tokens, on a router with tied gates (duplicated columns) and
    on a zero router (every gate equal): among equal gates the lower
    expert comes first, as ``jax.lax.top_k`` orders them.
  * The gather dispatch equals the einsum dispatch (the port of
    ``tests/test_models.py::test_moe_gather_matches_einsum``) and the
    reference's gather.
  * The init scales of the stacked experts (1/sqrt(D) in, 1/sqrt(F) out:
    a fan-in read from the stacked first dimension E would give
    1/sqrt(E)), the ``depth_scaled`` draw against the reference draw, and
    greedy decode against the full forward.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import Model, build, moe

ARCHS = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
TOL = 1e-4
ROUTE_TOL = 1e-6
DECODE_STEPS = 4
N_LAYERS = 2


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        from repro import configs as jconfigs
        from repro.models import build as jbuild
        from repro.models import moe as jmoe
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                              build=jbuild, moe=jmoe)


def _cfgs(ref, arch, use_kernels):
    jcfg = ref.configs.reduced(ref.configs.get(arch)).with_(
        use_kernels=use_kernels)
    cfg = configs.reduced(configs.get(arch)).with_(use_kernels=use_kernels)
    assert cfg.n_layers == N_LAYERS and cfg.family == "moe"
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights(ref):
    """The reference's initial weights per arch (host numpy), and the port's
    module made from them."""
    done = {}

    def get(arch):
        if arch not in done:
            jcfg, cfg = _cfgs(ref, arch, False)
            jp = ref.build(jcfg).init(ref.jax.random.PRNGKey(0))
            tree = ref.jax.device_get(jp)
            done[arch] = (jp, tree, model_params_from_numpy(cfg, tree,
                                                            device="cpu"))
        return done[arch]

    return get


@pytest.fixture(scope="module")
def runs(ref, weights):
    """Both models' outputs per (arch, use_kernels, S), computed once."""
    jax, jnp = ref.jax, ref.jnp
    done = {}

    def run(arch, use_kernels, S):
        key = (arch, use_kernels, S)
        if key in done:
            return done[key]
        jcfg, cfg = _cfgs(ref, arch, use_kernels)
        jm, m = ref.build(jcfg), build(cfg)
        jp, _, p = weights(arch)
        rng = np.random.default_rng(S + 7 * use_kernels)
        tokens = rng.integers(0, cfg.vocab, (2, S))
        nxt = rng.integers(0, cfg.vocab, (DECODE_STEPS, 2))
        max_len = S + DECODE_STEPS
        f32 = lambda x: np.asarray(x, np.float32)
        # a copy: the port's cache is written in place by later steps
        t32 = lambda x: x.float().numpy().copy()

        jl, jc = jax.jit(jm.prefill, static_argnums=2)(
            jp, jnp.asarray(tokens, jnp.int32), max_len)
        pl, pc = m.prefill(p, torch.from_numpy(tokens), max_len)
        out = {"prefill": (f32(jl), t32(pl)), "cache": [], "decode": []}
        assert int(jc["pos"]) == pc["pos"] == S
        for i in range(N_LAYERS):
            for kv in ("k", "v"):
                out["cache"].append((f32(jc[kv][i]), t32(pc[kv][i])))
        jdec = jax.jit(jm.decode_step)
        for s in range(DECODE_STEPS):
            jl, jc = jdec(jp, jnp.asarray(nxt[s], jnp.int32), jc)
            pl, pc = m.decode_step(p, torch.from_numpy(nxt[s]), pc)
            out["decode"].append((f32(jl), t32(pl)))
        assert pc["pos"] == max_len
        for i in range(N_LAYERS):
            for kv in ("k", "v"):
                out["cache"].append((f32(jc[kv][i]), t32(pc[kv][i])))
        jlog, jaux = jax.jit(jm.forward)(jp, jnp.asarray(tokens, jnp.int32))
        plog, paux = m.forward(p, torch.from_numpy(tokens))
        out["forward"] = (f32(jlog), t32(plog))
        out["aux"] = (float(jaux), float(paux))
        done[key] = SimpleNamespace(**out)
        return done[key]

    return run


def _close(pair, tol=TOL):
    want, got = pair
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


CASES = [(arch, use_kernels, S) for arch in ARCHS
         for use_kernels in (False, True) for S in (24, 128)]
IDS = [f"{a}-{'kernels' if k else 'plain'}-S{s}" for a, k, s in CASES]


@pytest.mark.parametrize("arch,use_kernels,S", CASES, ids=IDS)
def test_prefill_logits_and_cache(runs, arch, use_kernels, S):
    r = runs(arch, use_kernels, S)
    assert r.prefill[1].shape == (2, 1, 512)
    _close(r.prefill)
    for pair in r.cache:
        _close(pair)


@pytest.mark.parametrize("arch,use_kernels,S", CASES, ids=IDS)
def test_decode_steps(runs, arch, use_kernels, S):
    r = runs(arch, use_kernels, S)
    for pair in r.decode:
        assert pair[1].shape == (2, 512)
        _close(pair)


@pytest.mark.parametrize("arch,use_kernels,S", CASES, ids=IDS)
def test_forward_and_aux(runs, arch, use_kernels, S):
    r = runs(arch, use_kernels, S)
    _close(r.forward)
    np.testing.assert_allclose(r.aux[1], r.aux[0], rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    # the prefill's last-token logits are forward's last row
    np.testing.assert_allclose(r.prefill[1][:, 0], r.forward[1][:, -1],
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------


def _router_cases(cfg, rng):
    D, E = cfg.d_model, cfg.n_experts
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    tied = w.copy()
    tied[:, 1::2] = tied[:, 0::2]          # every gate value twice
    return {"seeded": w, "tied": tied, "zero": np.zeros((D, E), np.float32)}


def _port_ffn(cfg, arr):
    """A port MoEFFN whose every parameter is ``arr`` (the router) or a
    stand-in the routing does not read."""
    with torch.device("meta"):
        f = moe.MoEFFN(cfg)
    f = f.to_empty(device="cpu").requires_grad_(False)
    f.router.w.copy_(torch.from_numpy(arr))
    return f


@pytest.mark.parametrize("case", ["seeded", "tied", "zero"])
@pytest.mark.parametrize("G,T", [(1, 48), (4, 64), (1, 2)])
def test_route_equals_the_reference(ref, case, G, T):
    _, cfg = _cfgs(ref, "olmoe-1b-7b", False)
    rng = np.random.default_rng(G * 100 + T)
    w = _router_cases(cfg, rng)[case]
    xg = rng.standard_normal((G, T, cfg.d_model)).astype(np.float32)
    want = ref.moe._route(cfg, {"router": {"w": ref.jnp.asarray(w)}},
                          ref.jnp.asarray(xg))
    got = moe._route(cfg, _port_ffn(cfg, w), torch.from_numpy(xg))
    w_topi, w_topv, w_pos, w_keep, w_C, w_aux = want
    g_topi, g_topv, g_pos, g_keep, g_C, g_aux = got
    assert g_C == w_C == max(int(cfg.moe_capacity_factor * cfg.top_k * T
                                 / cfg.n_experts), 1)
    np.testing.assert_array_equal(g_topi.numpy(), np.asarray(w_topi))
    np.testing.assert_array_equal(g_pos.numpy(), np.asarray(w_pos))
    np.testing.assert_array_equal(g_keep.numpy(), np.asarray(w_keep))
    np.testing.assert_allclose(g_topv.numpy(), np.asarray(w_topv),
                               atol=ROUTE_TOL, rtol=ROUTE_TOL)
    np.testing.assert_allclose(float(g_aux), float(w_aux), atol=ROUTE_TOL,
                               rtol=ROUTE_TOL)
    if case == "zero":
        # every gate equal: the lowest experts, in order
        assert (g_topi.numpy() == np.arange(cfg.top_k)).all()
    if case == "tied":
        # each pair of equal gates in index order
        assert (g_topi[..., 0] % 2 == 0).all()
        assert (g_topi[..., 1] == g_topi[..., 0] + 1).all()
    if case == "zero":
        assert not g_keep.all()           # the capacity edge is exercised


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------


def test_gather_matches_einsum_and_the_reference(ref, weights):
    """The port of ``tests/test_models.py::test_moe_gather_matches_einsum``
    (its tolerances, 5e-3 on the logits, 1e-5 on aux), and the port's
    gather against the reference's gather within TOL."""
    jcfg, cfg = _cfgs(ref, "olmoe-1b-7b", False)
    jp, _, p = weights("olmoe-1b-7b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 64))
    out_e, aux_e = moe.forward(cfg.with_(moe_impl="einsum"), p,
                               torch.from_numpy(toks))
    out_g, aux_g = moe.forward(cfg.with_(moe_impl="gather"), p,
                               torch.from_numpy(toks))
    np.testing.assert_allclose(out_g.numpy(), out_e.numpy(), rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(float(aux_g), float(aux_e), rtol=1e-5)
    want, want_aux = ref.moe.forward(jcfg, jp,
                                     ref.jnp.asarray(toks, ref.jnp.int32),
                                     impl="gather")
    _close((np.asarray(want), out_g.numpy()))
    np.testing.assert_allclose(float(aux_g), float(want_aux), rtol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_apply(cfg.with_(moe_impl="dense"), p.layers[0].moe,
                      torch.zeros((1, 4, 128)))


def test_gather_is_the_same_on_every_run_and_drops_to_the_sentinel():
    """Kept slots get one token each and dropped choices add zeros to the
    sentinel row: the gather's output does not depend on the order of the
    adds (twice the same bits), and a token whose choices are all dropped
    gets zero from the MoE."""
    cfg = configs.reduced(configs.get("olmoe-1b-7b"))
    p = moe.init(cfg, seed=1, device="cpu").layers[0].moe
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    gather, einsum = cfg.with_(moe_impl="gather"), cfg.with_(moe_impl="einsum")
    a, _ = moe.moe_apply(gather, p, x)
    b, _ = moe.moe_apply(gather, p, x)
    assert torch.equal(a, b)
    # a zero router ties every gate: experts 0 and 1 for every token, one
    # group of 64 and C = 20, so tokens 20 onwards are dropped entirely
    p.router.w.zero_()
    y, _ = moe.moe_apply(gather, p, x[:1])
    assert torch.all(y[0, 20:] == 0) and not torch.all(y[0, :20] == 0)
    e, _ = moe.moe_apply(einsum, p, x[:1])
    torch.testing.assert_close(y, e, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# Init, interop, decode
# --------------------------------------------------------------------------


def test_init_scales_and_shapes_follow_the_reference(ref):
    """Shapes equal the reference's tree; the experts' and router's normal
    draws have the reference's scales (checked statistically: 1/sqrt(D)
    for wi, wg and the router, 1/sqrt(F) for wo, not 1/sqrt(E))."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(ref, arch, False)
        p = Model(cfg).init(seed=3, device="cpu")
        assert isinstance(p, moe.MoEParams)
        shapes = ref.jax.eval_shape(ref.build(jcfg).init,
                                    ref.jax.random.PRNGKey(0))
        flat = {}
        for path, leaf in ref.jax.tree_util.tree_flatten_with_path(
                shapes)[0]:
            keys = [k.key for k in path]
            if keys[0] == "layers":
                for i in range(leaf.shape[0]):
                    flat[".".join(["layers", str(i)] + keys[1:])] = \
                        leaf.shape[1:]
            else:
                flat[".".join(keys)] = leaf.shape
        got = {n: tuple(t.shape) for n, t in p.named_parameters()}
        assert got == {n: tuple(s) for n, s in flat.items()}
        D, Fe = cfg.d_model, cfg.d_expert
        want_scale = {"router.w": 1 / np.sqrt(D), "moe.wi": 1 / np.sqrt(D),
                      "moe.wg": 1 / np.sqrt(D), "moe.wo": 1 / np.sqrt(Fe)}
        for lp in p.layers:
            for key, scale in want_scale.items():
                t = lp.moe.router.w if key == "router.w" else \
                    getattr(lp.moe, key.split(".")[1])
                assert abs(float(t.std()) / scale - 1.0) < 0.05, (arch, key)
        assert torch.all(p.layers[0].ln2.scale == 1.0)
        q = Model(cfg).init(seed=3, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                     q.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_scaled_draw_rescales_the_reference_draw(arch):
    """``init(scheme="depth_scaled")`` is the reference draw of the same
    seed with the embedding at unit scale (times 50) and every layer's
    ``attn.wo`` and experts' ``wo`` times 1/sqrt(2 n_layers); every other
    parameter is equal."""
    cfg = configs.reduced(configs.get(arch))
    m = Model(cfg)
    a = dict(m.init(seed=5, device="cpu").named_parameters())
    b = dict(m.init(seed=5, device="cpu",
                    scheme="depth_scaled").named_parameters())
    f = 1.0 / np.sqrt(2 * cfg.n_layers)
    assert a.keys() == b.keys()
    for name, t in a.items():
        if name == "embed.table":
            want = t * 50.0
        elif name.endswith(".attn.wo.w") or name.endswith(".moe.wo"):
            want = t * f
        else:
            want = t
        assert torch.equal(b[name], want), name
    assert abs(float(b["embed.table"].std()) - 1.0) < 0.05


@pytest.mark.parametrize("arch,scheme", [
    ("qwen2-7b", "depth_scaled"), ("seamless-m4t-medium", "depth_scaled"),
    ("mamba2-2.7b", "depth_scaled"), ("olmoe-1b-7b", "trained")])
def test_init_refuses_an_unknown_scheme_or_another_family(arch, scheme):
    cfg = configs.reduced(configs.get(arch))
    with pytest.raises(ValueError):
        Model(cfg).init(seed=0, device="cpu", scheme=scheme)


def test_interop_maps_the_stacked_experts(ref, weights):
    _, tree, p = weights("olmoe-1b-7b")
    assert tree["layers"]["moe"]["wi"].shape == (N_LAYERS, 8, 128, 64)
    np.testing.assert_array_equal(p.layers[1].moe.wo.numpy(),
                                  tree["layers"]["moe"]["wo"][1])
    np.testing.assert_array_equal(p.layers[0].moe.router.w.numpy(),
                                  tree["layers"]["moe"]["router"]["w"][0])
    bad = {**tree, "layers": {**tree["layers"], "moe": {
        **tree["layers"]["moe"],
        "wi": tree["layers"]["moe"]["wi"][:, :, :, :32]}}}
    _, cfg = _cfgs(ref, "olmoe-1b-7b", False)
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(cfg, bad, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_matches_forward(arch, use_kernels):
    """Greedy decode logits equal the full forward's at the same positions
    (the port of ``tests/test_models.py::test_decode_matches_forward``,
    2e-2), with groups large enough that no choice is dropped: a decode
    step routes 2 tokens in a group of its own, so capacity differs from
    the forward's unless nothing overflows."""
    cfg = configs.reduced(configs.get(arch)).with_(
        use_kernels=use_kernels, moe_capacity_factor=8.0)
    model = build(cfg)
    params = model.init(seed=0, device="cpu")
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    full, _ = model.forward(params, toks)
    logits, cache = model.prefill(params, toks[:, :16], max_len=S + 8)
    torch.testing.assert_close(logits[:, 0], full[:, 15], rtol=2e-2,
                               atol=2e-2)
    for t in range(16, 20):
        lg, cache = model.decode_step(params, toks[:, t], cache)
        torch.testing.assert_close(lg, full[:, t], rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# The one-token step by the chosen experts (kernels.expert_gather)
# --------------------------------------------------------------------------


def _layer(arch="olmoe-1b-7b", **kw):
    cfg = configs.reduced(configs.get(arch)).with_(**kw)
    params = build(cfg).init(seed=0, device="cpu")
    return cfg, params.layers[0].moe


@pytest.mark.parametrize("B", [1, 3])
def test_gathered_experts_equal_the_dense_path_at_one_token(B):
    """``expert_gather_plain`` over ``_route``'s choices, weighted ``topv *
    keep``, equals the dense GShard path (``_moe_einsum``) on one token a
    sequence, in f32: at B = 1 (capacity 1 >= T, nothing drops) and at B =
    3 (capacity 1 < T = 3: choices drop); and ``moe_apply`` with the
    kernels on (the gathered path) equals it with them off."""
    from repro_torch.kernels.expert_gather import expert_gather_plain
    cfg, p = _layer()
    x = torch.from_numpy(np.random.default_rng(B).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    xg = x.reshape(1, B, cfg.d_model)
    with torch.no_grad():
        topi, topv, positions, keep, C, _ = moe._route(cfg, p, xg)
        assert bool(keep.all()) == (B == 1) and (C >= B) == (B == 1)
        want = moe._moe_einsum(cfg, p, xg, topi, topv, positions, keep, C)
        got = expert_gather_plain(xg[0], topi[0], (topv * keep)[0], p.wi,
                                  p.wg, p.wo)
        torch.testing.assert_close(got, want[0], atol=1e-5, rtol=1e-5)
        for need_aux in (True, False):
            y, _ = moe.moe_apply(cfg.with_(use_kernels=True), p, x,
                                 need_aux=need_aux)
            torch.testing.assert_close(y, moe.moe_apply(cfg, p, x)[0],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("G,T,cf", [(1, 1, 1.25), (1, 2, 8.0), (3, 4, 8.0),
                                    (2, 64, 4.0)])
def test_capacity_shortcut_keeps_every_choice_of_the_routers_top_k(G, T,
                                                                   cf):
    """Where capacity C >= T no choice can drop: ``_route`` keeps every
    choice, and ``_topk`` (the shortcut's routing, no slot loop) gives its
    topi and topv exactly."""
    cfg, p = _layer(moe_capacity_factor=cf)
    assert moe._capacity(cfg, T) >= T
    xg = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (G, T, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        topi, topv, _, keep, C, _ = moe._route(cfg, p, xg)
        _, ti, tv = moe._topk(cfg, p, xg)
    assert C >= T and bool(keep.all())
    assert torch.equal(ti, topi) and torch.equal(tv, topv)


def test_one_token_step_skips_the_slot_loop_where_capacity_cannot_bind(
        monkeypatch):
    """A decode step (no aux loss wanted) at C >= T routes by ``_topk``
    alone; with the aux loss wanted, or at C < T, ``_route`` runs."""
    cfg, p = _layer(use_kernels=True)
    calls = []
    real = moe._route
    monkeypatch.setattr(moe, "_route",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        for B, need_aux, routed in ((1, False, 0), (1, True, 1),
                                    (3, False, 1)):
            calls.clear()
            y, aux = moe.moe_apply(cfg, p, torch.ones(B, 1, cfg.d_model),
                                   need_aux=need_aux)
            assert len(calls) == routed and (aux is None) == (not routed)


def _counting(monkeypatch):
    """Count the gathered path's calls on the CPU, where the wrapper runs
    the plain version (the card's kernel counts its own in LAUNCHES)."""
    from repro_torch.kernels import expert_gather as EG
    real = EG.expert_gather_plain

    def counted(*a):
        EG.LAUNCHES += 1
        return real(*a)
    monkeypatch.setattr(EG, "expert_gather_plain", counted)
    return EG


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_path_runs_where_the_choices_reach_every_expert(monkeypatch,
                                                              arch):
    """The gathered path runs while B * top_k < E (B 1-3 of top 2 of 8),
    and never at B * top_k >= E (B 4), with the kernels off, or over a
    prompt: the launch counter stays still there."""
    EG = _counting(monkeypatch)
    cfg, p = _layer(arch, use_kernels=True)
    with torch.no_grad():
        for B, S, kernels, runs in ((1, 1, True, 1), (3, 1, True, 1),
                                    (4, 1, True, 0), (5, 1, True, 0),
                                    (1, 1, False, 0), (1, 8, True, 0)):
            n0 = EG.LAUNCHES
            moe.moe_apply(cfg.with_(use_kernels=kernels), p,
                          torch.ones(B, S, cfg.d_model))
            assert EG.LAUNCHES - n0 == runs, (B, S, kernels)


def test_engine_counts_the_gathered_calls_of_a_request(monkeypatch):
    """``last_times["expert_gather_launches"]``: MoE layers x decode steps
    of the request (2 x 5 here), none in the prefill."""
    from repro_torch.serving import engine as port_engine
    from repro_torch.serving import registry as port_registry
    _counting(monkeypatch)
    cfg = configs.reduced(configs.get("olmoe-1b-7b")).with_(use_kernels=True)
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("app-0", cfg, seed=1))
    eng = port_engine.ServeEngine(reg, device="cpu")
    eng.load("app-0")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 24)))
    for new in (6, 2):
        eng.generate("app-0", tokens, max_new=new, max_len=32)
        assert eng.last_times["expert_gather_launches"] == \
            N_LAYERS * (new - 1)
