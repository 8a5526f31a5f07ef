"""The serve engine's executable cache (``repro_torch.serving.engine``:
``Executable``, ``ServeEngine._executables``), the port of the reference's
``ServeEngine._executables`` (``repro/serving/engine.py``), and the device
position that its captured decode step rests on.

  * every family's prefill leaves ``pos`` as a 0-d int64 tensor, and six
    teacher-forced ``decode_step``s from it agree with the reference's
    jitted ``decode_step`` at the family's model-test tolerance (f32: 1e-4
    dense, MoE and encoder-decoder, 5e-5 hybrid and SSM). Reduced configs,
    prompt 24 with ``use_kernels``: the decode kernel's plain version takes
    ``kv_len`` as a device tensor, and the hybrid's 16-slot ring wraps;
  * an entry's greedy decode on the CPU (the step with its state copied
    back, as the card's graph runs it) equals the eager ``decode_step``
    loop bit for bit, tokens and last logits; a second request through the
    same entry (its prefill copied into the entry's state) gives the same
    tokens; the entry's state owns its storage (no view of a prompt-sized
    tensor);
  * ``_executables`` keeps one entry per (app, ``max_len``, batch);
    ``unload`` and a re-``load`` drop the app's entries; a prompt that
    would overrun ``max_len`` raises before any step; ``generate`` under a
    mesh raises; the launch counters' arithmetic for replays;
  * the families whose attention decodes through a KV cache count the
    rotary-and-append kernel's launches in ``Model.counters()``;
  * on a CUDA card (``gpu``, skipped elsewhere) at reduced bf16 configs:
    graph decode equal to eager decode bit for bit in every family, again
    after an unload and reload (a second capture), with the counted
    launches per request equal to the eager path's; a dense graph's
    replays count one rotary-and-append launch an attention layer.

``tests/test_torch_serving.py`` holds ``generate``'s tokens to the
reference's ``ServeEngine``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs, kernels
from repro_torch.interop import model_params_from_numpy
from repro_torch.kernels import decode_attention as DA
from repro_torch.models import build
from repro_torch.serving import engine as port_engine
from repro_torch.serving import registry as port_registry

# family -> (arch, n_layers, f32 tolerance of the family's model tests)
FAMILIES = {"dense": ("qwen2-7b", 2, 1e-4),
            "hybrid": ("recurrentgemma-2b", 5, 5e-5),
            "ssm": ("mamba2-2.7b", 2, 5e-5),
            "moe": ("olmoe-1b-7b", 2, 1e-4),
            "encdec": ("seamless-m4t-medium", 2, 1e-4)}
S, STEPS = 24, 6


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
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                              build=jbuild)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family, **kw):
    arch, n_layers, _ = FAMILIES[family]
    return configs.reduced(configs.get(arch)).with_(
        n_layers=n_layers, use_kernels=True, **kw)


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (2, S))
    frames = None
    if cfg.family == "encdec":
        frames = (0.02 * rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    return tokens, frames, rng.integers(0, cfg.vocab, (STEPS, 2))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_with_device_pos_matches_reference(ref, family):
    jax, jnp = ref.jax, ref.jnp
    arch, n_layers, tol = FAMILIES[family]
    cfg = _cfg(family)
    jcfg = ref.configs.reduced(ref.configs.get(arch)).with_(
        n_layers=n_layers, use_kernels=True)
    jm, m = ref.build(jcfg), build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
    tokens, frames, nxt = _inputs(cfg, 11)
    max_len = S + STEPS
    jkw = {} if frames is None else {"embeds": jnp.asarray(frames)}
    pkw = {} if frames is None else {"embeds": torch.from_numpy(frames)}
    _, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len, **jkw))(
        jp, jnp.asarray(tokens, jnp.int32))
    with torch.inference_mode():
        _, pc = m.prefill(p, torch.from_numpy(tokens), max_len, **pkw)
    jdec = jax.jit(jm.decode_step)
    for s in range(STEPS):
        pos = pc["pos"]
        assert isinstance(pos, torch.Tensor) and pos.shape == () \
            and pos.dtype == torch.int64 and pos.device.type == "cpu"
        assert int(pos) == int(jc["pos"]) == S + s
        jl, jc = jdec(jp, jnp.asarray(nxt[s], jnp.int32), jc)
        with torch.inference_mode():
            pl, pc = m.decode_step(p, torch.from_numpy(nxt[s]), pc)
        assert pc["pos"] is not pos and int(pos) == S + s   # a new tensor
        np.testing.assert_allclose(pl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=tol, rtol=tol)
    assert int(pc["pos"]) == int(jc["pos"]) == max_len


def _engine(family, n_apps=1, **kw):
    reg = port_registry.Registry()
    cfg = _cfg(family, **kw)
    for i in range(n_apps):
        reg.register(port_registry.ModelEndpoint(f"app-{i}", cfg, seed=5 + i))
    return port_engine.ServeEngine(reg, device="cpu"), cfg


def _storage_owned(tree):
    if isinstance(tree, dict):
        return all(_storage_owned(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_storage_owned(v) for v in tree)
    return tree.untyped_storage().nbytes() == \
        tree.numel() * tree.element_size()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_entry_decode_equals_the_eager_loop(family):
    eng, cfg = _engine(family)
    eng.load("app-0")
    params, model = eng._loaded["app-0"], eng._model(cfg)
    tokens = torch.from_numpy(_inputs(cfg, 3)[0])
    embeds = model.frontend(tokens)
    max_len = S + STEPS
    with torch.inference_mode():
        logits, state = model.prefill(params, tokens, max_len, embeds=embeds)
        tok = torch.argmax(logits, dim=-1)[:, 0]
        want = [tok]
        for _ in range(STEPS):
            logits, state = model.decode_step(params, tok, state)
            tok = torch.argmax(logits, dim=-1)
            want.append(tok)
    entry = eng._executables("app-0", max_len, 2)
    for request in range(2):
        got = [entry.prefill(tokens, embeds)]
        got += [entry.decode() for _ in range(STEPS)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), request
        assert torch.equal(entry.logits, logits)
        assert int(entry.state["pos"]) == max_len
    assert entry.graph is None and _storage_owned(entry.state)
    out, _ = eng.generate("app-0", tokens, max_new=STEPS + 1,
                          max_len=max_len)
    assert torch.equal(out, torch.stack(want, dim=1))
    assert eng._executables("app-0", max_len, 2) is entry


def test_executables_are_kept_per_app_max_len_and_batch():
    eng, cfg = _engine("dense", n_apps=2)
    for app in ("app-0", "app-1"):
        eng.load(app)
    a = eng._executables("app-0", 32, 2)
    assert eng._executables("app-0", 32, 2) is a
    others = [eng._executables("app-0", 64, 2),
              eng._executables("app-0", 32, 1),
              eng._executables("app-1", 32, 2)]
    assert all(o is not a for o in others)
    assert len({id(o) for o in others}) == 3
    assert set(eng._exec_cache) == {("app-0", 32, 2), ("app-0", 64, 2),
                                    ("app-0", 32, 1), ("app-1", 32, 2)}
    assert a.params is eng._loaded["app-0"]
    with pytest.raises(KeyError):
        eng._executables("app-2", 32, 2)


def test_unload_and_reload_drop_the_apps_entries():
    eng, cfg = _engine("hybrid", n_apps=2)
    for app in ("app-0", "app-1"):
        eng.load(app)
    toks = torch.zeros((2, 8), dtype=torch.long)
    first, _ = eng.generate("app-0", toks, max_new=3, max_len=16)
    eng.generate("app-1", toks, max_new=3, max_len=16)
    old = eng._executables("app-0", 16, 2)
    assert old.state is not None
    eng.load("app-0")                       # a reload: a new device copy
    assert ("app-0", 16, 2) not in eng._exec_cache
    assert ("app-1", 16, 2) in eng._exec_cache
    assert old.state is None and old.token is None        # closed
    again, _ = eng.generate("app-0", toks, max_new=3, max_len=16)
    assert torch.equal(first, again)
    assert eng._executables("app-0", 16, 2).params is eng._loaded["app-0"]
    eng.unload("app-1")
    assert set(eng._exec_cache) == {("app-0", 16, 2)}
    eng.unload("app-0")
    assert not eng._exec_cache and not eng.is_loaded("app-0")


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_prompt_overrunning_max_len_raises_before_any_step(family):
    eng, cfg = _engine(family)
    eng.load("app-0")
    toks = torch.zeros((2, 10), dtype=torch.long)
    with pytest.raises(ValueError, match="more than max_len 12"):
        eng.generate("app-0", toks, max_new=4, max_len=12)
    assert not eng._exec_cache and eng.last_times == {}
    out, _ = eng.generate("app-0", toks, max_new=3, max_len=12)
    assert out.shape == (2, 3)
    counters = {"state_bytes"} | ({"ssd_launches"} if family == "ssm"
                                  else {"rope_append_launches"})
    assert set(eng.last_times) == {"prefill_s", "decode_s"} | counters
    if family == "dense":                    # plain version: no launch
        assert eng.last_times["rope_append_launches"] == 0


@pytest.mark.parametrize("family", list(FAMILIES) + ["nemotron_h"])
def test_attention_families_count_rope_append_launches(family):
    """``Model.counters()`` carries the rotary-and-append kernel's launches
    for every family whose attention layers decode through a KV cache
    (dense, MoE, encoder-decoder, Nemotron-H's GQA layers), read from the
    kernel's module; not for RecurrentGemma (its local attention decodes
    against a ring buffer of its own) or Mamba-2."""
    from repro_torch.kernels import rope_append as RA
    cfg = configs.reduced(configs.get("nemotron-3-nano-30b-a3b")) \
        if family == "nemotron_h" else _cfg(family)
    counters = build(cfg).counters()
    if family in ("hybrid", "ssm"):
        assert "rope_append_launches" not in counters
    else:
        assert counters["rope_append_launches"] == RA.LAUNCHES


def test_generate_under_a_mesh_raises(monkeypatch):
    eng, cfg = _engine("dense")
    eng.load("app-0")
    monkeypatch.setattr(port_engine.ctx, "active_mesh", lambda: object())
    with pytest.raises(RuntimeError, match="one device"):
        eng.generate("app-0", torch.zeros((1, 4), dtype=torch.long))
    assert not eng._exec_cache


def test_launch_counts_are_added_per_replay_and_taken_back():
    """What a capture counted is taken back (nothing ran) and added once
    per replay, by kernel and by form (``kernels.launch_counts``,
    ``kernels.add_launches``, which the entry's capture and replay use)."""
    before = kernels.launch_counts()
    delta = [(0, {f: 0 for f in forms}) for _, forms in before]
    i = kernels.MODEL_KERNELS.index(DA)
    delta[i] = (3, {"tensor_cores": 3, "cuda_cores": 0})
    try:
        kernels.add_launches(delta)
        kernels.add_launches(delta)
        assert DA.LAUNCHES == before[i][0] + 6
        assert DA.LAUNCHES_BY_FORM["tensor_cores"] == \
            before[i][1]["tensor_cores"] + 6
        assert kernels.launch_counts(since=before)[i] == \
            (6, {"tensor_cores": 6, "cuda_cores": 0})
        kernels.add_launches(delta, -1)
        assert DA.LAUNCHES == before[i][0] + 3
    finally:
        kernels.add_launches(delta, -1)
    assert kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


_counted = kernels.launch_counts


@pytest.mark.gpu
def test_dense_graph_replays_count_rope_append_once_a_layer():
    """Reduced Qwen2-7B in bf16 with the kernels at batch 1: the entry's
    decode graph gives the eager greedy tokens bit for bit, and each of its
    replays counts one rotary-and-append launch an attention layer (the
    request's ``last_times`` one a layer for the prefill and for each
    step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step's graph is "
                    "captured there only")
    from repro_torch.kernels import rope_append as RA
    new = 9
    cfg = _cfg("dense", dtype="bfloat16").with_(n_layers=3)
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("app-0", cfg, seed=5))
    eng = port_engine.ServeEngine(reg, device="cuda")
    eng.load("app-0")
    params, model = eng._loaded["app-0"], eng._model(cfg)
    tokens = torch.from_numpy(_inputs(cfg, 3)[0][:1]).cuda()
    max_len = S + new
    with torch.inference_mode():
        lg, state = model.prefill(params, tokens, max_len)
        tok = torch.argmax(lg, dim=-1)[:, 0]
        want = [tok]
        for _ in range(new - 1):
            lg, state = model.decode_step(params, tok, state)
            tok = torch.argmax(lg, dim=-1)
            want.append(tok)
    want = torch.stack(want, dim=1)
    out, _ = eng.generate("app-0", tokens, max_new=new, max_len=max_len)
    assert torch.equal(out, want)
    assert eng.last_times["rope_append_launches"] == cfg.n_layers * new
    entry = eng._executables("app-0", max_len, 1)
    assert entry.graph is not None
    entry.prefill(tokens, None)
    i = kernels.MODEL_KERNELS.index(RA)
    for _ in range(new - 1):
        c0 = _counted()
        entry.decode()
        assert _counted(since=c0)[i] == (cfg.n_layers, {})
    eng.unload("app-0")


@pytest.mark.gpu
def test_graph_decode_equals_eager_bit_for_bit():
    """Each family at a reduced bf16 config with the kernels: the tokens
    and every step's logits of the entry's graph equal the eager greedy
    loop's from the same prefill, bit for bit; ``generate`` gives the same
    tokens with the launches of the eager path counted through replays;
    an unload and reload captures anew and gives them again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode step's graph is "
                    "captured there only")
    new = 9
    for family in FAMILIES:
        reg = port_registry.Registry()
        cfg = _cfg(family, dtype="bfloat16")
        reg.register(port_registry.ModelEndpoint("app-0", cfg, seed=5))
        eng = port_engine.ServeEngine(reg, device="cuda")
        eng.load("app-0")
        params, model = eng._loaded["app-0"], eng._model(cfg)
        tokens = torch.from_numpy(_inputs(cfg, 3)[0]).cuda()
        embeds = model.frontend(tokens)
        max_len = S + new
        c0 = _counted()
        with torch.inference_mode():
            lg, state = model.prefill(params, tokens, max_len, embeds=embeds)
            tok = torch.argmax(lg, dim=-1)[:, 0]
            want, want_logits = [tok], []
            for _ in range(new - 1):
                lg, state = model.decode_step(params, tok, state)
                tok = torch.argmax(lg, dim=-1)
                want.append(tok)
                want_logits.append(lg.clone())
        torch.cuda.synchronize()
        eager = _counted(since=c0)
        want = torch.stack(want, dim=1)
        for load in range(2):
            c0 = _counted()
            out, _ = eng.generate("app-0", tokens, max_new=new,
                                  max_len=max_len)
            assert _counted(since=c0) == eager, (family, load)
            assert eng.last_times["capture_s"] > 0.0
            assert torch.equal(out, want), (family, load)
            entry = eng._executables("app-0", max_len, 2)
            assert entry.graph is not None
            c0 = _counted()
            got = [entry.prefill(tokens, embeds)]
            logits = []
            for _ in range(new - 1):
                got.append(entry.decode())
                logits.append(entry.logits.clone())
            torch.cuda.synchronize()
            assert _counted(since=c0) == eager, (family, load)
            assert torch.equal(torch.stack(got, dim=1), want), family
            assert all(torch.equal(a, b) for a, b in zip(logits,
                                                         want_logits))
            out, _ = eng.generate("app-0", tokens, max_new=new,
                                  max_len=max_len)
            assert eng.last_times["capture_s"] == 0.0
            assert torch.equal(out, want)
            eng.unload("app-0")
            eng.load("app-0")
        eng.unload("app-0")
