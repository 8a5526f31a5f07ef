"""The port's frontend families against the reference's, on the same
weights and the same frontend embeddings: the encoder-decoder
(``transformer.encdec_*``, SeamlessM4T) and the VLM backbone (the dense
family given ``embeds``, LLaVA-NeXT).

Configs: ``reduced(get("seamless-m4t-medium"))`` (2 encoder and 2 decoder
layers, d_model 128, 4 heads of 32, 8 frames) and
``reduced(get("llava-next-34b"))`` (2 layers, 4 q heads over 2 KV heads, 8
patches prepended to the text). The weights come from the reference's
``Model.init`` through ``interop.model_params_from_numpy``; the frames and
patches are ``0.02 * normal`` from a numpy seed.

For ``use_kernels`` False and True, at S = 24 and 128 (the sequence the
decoder's self-attention sees: for LLaVA the 8 patches and S - 8 text
tokens, so that S = 128 meets the prefill's kernel condition):
``forward``, ``prefill``'s last-token logits and its cache (the encoder's
states ``"enc"`` included), and four teacher-forced ``decode_step``s, in
f32 within atol = rtol = 1e-4. The encoder's self-attention is not causal
and the cross-attention reads a memory: both take the plain ``_sdpa`` on
either branch, as in the reference.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import Model, build, frontend, transformer

ARCHS = ("seamless-m4t-medium", "llava-next-34b")
TOL = 1e-4
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
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                              build=jbuild)


def _cfgs(ref, arch, use_kernels):
    jcfg = ref.configs.reduced(ref.configs.get(arch)).with_(
        use_kernels=use_kernels)
    cfg = configs.reduced(configs.get(arch)).with_(use_kernels=use_kernels)
    assert cfg.n_layers == N_LAYERS and cfg.frontend_tokens == 8
    return jcfg, cfg


def _inputs(cfg, S, seed):
    """(tokens [2, S_text], embeds [2, 8, D], next tokens) from a seed."""
    rng = np.random.default_rng(seed)
    s_text = S - cfg.frontend_tokens if cfg.frontend == "vision" else S
    tokens = rng.integers(0, cfg.vocab, (2, s_text))
    embeds = (0.02 * rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab, (DECODE_STEPS, 2))
    return tokens, embeds, nxt


@pytest.fixture(scope="module")
def runs(ref):
    """Both models' outputs per (arch, use_kernels, S), computed once."""
    jax, jnp = ref.jax, ref.jnp
    done, weights = {}, {}

    def run(arch, use_kernels, S):
        key = (arch, use_kernels, S)
        if key in done:
            return done[key]
        jcfg, cfg = _cfgs(ref, arch, use_kernels)
        jm, m = ref.build(jcfg), build(cfg)
        if arch not in weights:
            jp = ref.build(jcfg).init(jax.random.PRNGKey(0))
            weights[arch] = (jp, model_params_from_numpy(
                cfg, jax.device_get(jp), device="cpu"))
        jp, p = weights[arch]
        tokens, embeds, nxt = _inputs(cfg, S, S + 7 * use_kernels)
        jt, je = jnp.asarray(tokens, jnp.int32), jnp.asarray(embeds)
        pt, pe = torch.from_numpy(tokens), torch.from_numpy(embeds)
        max_len = S + DECODE_STEPS
        f32 = lambda x: np.asarray(x, np.float32)
        t32 = lambda x: x.float().numpy().copy()

        jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, jt, max_len, je)
        pl, pc = m.prefill(p, pt, max_len, embeds=pe)
        out = {"prefill": (f32(jl), t32(pl)), "cache": [], "decode": []}
        assert int(jc["pos"]) == pc["pos"] == S
        assert ("enc" in pc) == (cfg.family == "encdec")
        if "enc" in pc:
            out["cache"].append((f32(jc["enc"]), t32(pc["enc"])))
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
        out["forward"] = (f32(jax.jit(jm.forward)(jp, jt, je)),
                          t32(m.forward(p, pt, embeds=pe)))
        done[key] = SimpleNamespace(**out)
        return done[key]

    return run


def _close(pair):
    want, got = pair
    assert want.shape == got.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


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
def test_forward(runs, arch, use_kernels, S):
    r = runs(arch, use_kernels, S)
    _close(r.forward)
    np.testing.assert_allclose(r.prefill[1][:, 0], r.forward[1][:, -1],
                               atol=1e-5, rtol=1e-5)


def test_init_follows_the_reference_tree(ref):
    """The encoder-decoder's parameter names and shapes equal the
    reference's tree (two stacked keys, ``enc_layers`` and ``layers``);
    the cross-attention is initialised like the self-attention."""
    jcfg, cfg = _cfgs(ref, "seamless-m4t-medium", False)
    p = Model(cfg).init(seed=3, device="cpu")
    assert isinstance(p, transformer.EncDecParams)
    shapes = ref.jax.eval_shape(ref.build(jcfg).init,
                                ref.jax.random.PRNGKey(0))
    flat = {}
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        if keys[0] in ("layers", "enc_layers"):
            for i in range(leaf.shape[0]):
                flat[".".join([keys[0], str(i)] + keys[1:])] = leaf.shape[1:]
        else:
            flat[".".join(keys)] = leaf.shape
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert got == {n: tuple(s) for n, s in flat.items()}
    for name, t in p.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf == "scale":
            assert torch.all(t == 1.0)
        elif leaf == "w":
            assert abs(float(t.std()) * np.sqrt(t.shape[0]) - 1.0) < 0.1, \
                name


def test_encdec_needs_frames_and_other_families_take_none():
    cfg = configs.reduced(configs.get("seamless-m4t-medium"))
    m = Model(cfg)
    p = m.init(seed=0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.long)
    for call in (lambda: m.forward(p, toks), lambda: m.prefill(p, toks, 8)):
        with pytest.raises(ValueError, match="frame embeddings"):
            call()
    other = configs.reduced(configs.get("olmoe-1b-7b"))
    mo = Model(other)
    po = mo.init(seed=0, device="cpu")
    with pytest.raises(ValueError, match="no frontend embeddings"):
        mo.prefill(po, toks, 8, embeds=torch.zeros((2, 1, other.d_model)))


def test_frontend_stubs_are_seeded_and_shaped():
    for arch in ARCHS:
        cfg = configs.reduced(configs.get(arch))
        fn = frontend.vision_patches if cfg.frontend == "vision" \
            else frontend.audio_frames
        a = fn(cfg, 3, torch.Generator().manual_seed(5), device="cpu")
        b = fn(cfg, 3, torch.Generator().manual_seed(5), device="cpu")
        assert a.shape == (3, cfg.frontend_tokens, cfg.d_model)
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert abs(float(a.std()) / 0.02 - 1.0) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_matches_forward(arch, use_kernels):
    """Greedy decode logits equal the full forward's at the same positions
    (the port of ``tests/test_models.py::test_decode_matches_forward``,
    2e-2), with the frames or patches given to both."""
    cfg = configs.reduced(configs.get(arch)).with_(use_kernels=use_kernels)
    model = build(cfg)
    params = model.init(seed=0, device="cpu")
    B, S = 2, 24
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    embeds = frontend.audio_frames(cfg, B, torch.Generator().manual_seed(2),
                                   device="cpu")
    full = model.forward(params, toks, embeds=embeds)
    n_f = cfg.frontend_tokens if cfg.family == "dense" else 0
    logits, cache = model.prefill(params, toks[:, :16], max_len=S + n_f + 8,
                                  embeds=embeds)
    torch.testing.assert_close(logits[:, 0], full[:, n_f + 15], rtol=2e-2,
                               atol=2e-2)
    for t in range(16, 20):
        lg, cache = model.decode_step(params, toks[:, t], cache)
        torch.testing.assert_close(lg, full[:, n_f + t], rtol=2e-2,
                                   atol=2e-2)
