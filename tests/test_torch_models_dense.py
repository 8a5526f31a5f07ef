"""The port's dense family (``repro_torch.models.transformer``) end to end
against the reference's, on the same weights.

Configs: ``reduced(get("qwen2-7b"))`` (2 layers, d_model 128, 4 q heads over
2 KV heads of 32, QKV biases, an untied ``head``, vocab 512) and
``reduced(get("smollm-135m"))`` (the same widths, no biases, the
unembedding tied to the embedding). The weights come from the reference's
``Model.init`` and cross through ``interop.model_params_from_numpy``.

For ``use_kernels`` False and True, at a prompt length that is not a
multiple of 128 (24) and one that is (128, the prefill's kernel
condition): ``forward``, ``prefill``'s last-token logits and its KV cache,
and four teacher-forced ``decode_step``s, all in f32 within atol = rtol =
1e-4 (the matrix products and softmaxes sum in another order than XLA's,
through two layers; logits are of order 1). On the CPU the port's kernel
branches run the kernels' plain versions (``flash_attention_plain``,
``decode_attention_plain``), the reference's prefill and decode its plain
``_sdpa`` over the cache, and its ``forward`` at S=128 its Pallas attention
kernel in interpret mode.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import Model, build, transformer

ARCHS = ("qwen2-7b", "smollm-135m")
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
    assert cfg.n_layers == N_LAYERS and cfg.family == "dense"
    return jcfg, cfg


@pytest.fixture(scope="module")
def runs(ref):
    """Both models' outputs per (arch, use_kernels, S), computed once."""
    jax, jnp = ref.jax, ref.jnp
    done = {}

    def run(arch, use_kernels, S):
        key = (arch, use_kernels, S)
        if key in done:
            return done[key]
        jcfg, cfg = _cfgs(ref, arch, use_kernels)
        jm, m = ref.build(jcfg), build(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
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
        out["forward"] = (
            f32(jax.jit(jm.forward)(jp, jnp.asarray(tokens, jnp.int32))),
            t32(m.forward(p, torch.from_numpy(tokens))))
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
    # the prefill's last-token logits are forward's last row
    np.testing.assert_allclose(r.prefill[1][:, 0], r.forward[1][:, -1],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_decode_matches_forward(arch, use_kernels):
    """The port of ``tests/test_models.py::test_decode_matches_forward`` (on
    the port alone): greedy decode logits equal the full forward's at the
    same positions, within that test's 2e-2."""
    cfg = configs.reduced(configs.get(arch)).with_(use_kernels=use_kernels)
    model = build(cfg)
    params = model.init(seed=0, device="cpu")
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    full = model.forward(params, toks)
    logits, cache = model.prefill(params, toks[:, :16], max_len=S + 8)
    torch.testing.assert_close(logits[:, 0], full[:, 15], rtol=2e-2,
                               atol=2e-2)
    for t in range(16, 20):
        lg, cache = model.decode_step(params, toks[:, t], cache)
        torch.testing.assert_close(lg, full[:, t], rtol=2e-2, atol=2e-2)


def test_init_follows_the_reference_distributions(ref):
    """Shapes equal the reference's tree; zero QKV biases, unit scales; the
    normal draws have the reference's scales (checked statistically: a
    torch.Generator does not give jax.random's numbers); the same seed
    gives the same weights."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(ref, arch, False)
        p = Model(cfg).init(seed=3, device="cpu")
        assert isinstance(p, transformer.DenseParams)
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
        assert ("head.w" in got) == (not cfg.tie_embeddings)
        assert any(n.endswith("wq.b") for n in got) == cfg.qkv_bias
        for name, t in p.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "scale":
                assert torch.all(t == 1.0)
            elif leaf == "b":
                assert torch.all(t == 0.0)
            else:
                scale = 0.02 if leaf == "table" else 1.0 / np.sqrt(
                    t.shape[0])
                assert abs(float(t.std()) / scale - 1.0) < 0.1, name
        q = Model(cfg).init(seed=3, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                     q.parameters()))


def test_interop_maps_biases_and_head(ref):
    jcfg, cfg = _cfgs(ref, "qwen2-7b", False)
    t = ref.jax.device_get(ref.build(jcfg).init(ref.jax.random.PRNGKey(1)))
    t["layers"]["attn"]["wk"]["b"] = np.arange(
        t["layers"]["attn"]["wk"]["b"].size, dtype=np.float32).reshape(
        t["layers"]["attn"]["wk"]["b"].shape)
    p = model_params_from_numpy(cfg, t, device="cpu")
    np.testing.assert_array_equal(p.layers[1].attn.wk.b.numpy(),
                                  t["layers"]["attn"]["wk"]["b"][1])
    np.testing.assert_array_equal(p.head.w.numpy(), t["head"]["w"])
    del t["head"]
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(cfg, t, device="cpu")


def test_cache_is_written_in_place_and_bounded():
    """The prefill's cache is preallocated at ``max_len`` and each decode
    step writes one position of it in place; a step past the capacity
    raises."""
    cfg = configs.reduced(configs.get("qwen2-7b"))
    m = build(cfg)
    p = m.init(seed=0, device="cpu")
    toks = torch.zeros((2, 5), dtype=torch.long)
    _, cache = m.prefill(p, toks, max_len=6)
    assert [tuple(k.shape) for k in cache["k"]] == [(2, 6, 2, 32)] * 2
    k0 = cache["k"][0]
    assert torch.all(k0[:, 5:] == 0) and not torch.all(k0[:, :5] == 0)
    _, c2 = m.decode_step(p, torch.tensor([1, 2]), cache)
    assert c2["k"][0] is k0 and c2["pos"] == 6
    assert not torch.all(k0[:, 5] == 0)
    with pytest.raises(ValueError, match="full"):
        m.decode_step(p, torch.tensor([1, 2]), c2)
    with pytest.raises(ValueError, match="max_len"):
        m.prefill(p, toks, max_len=4)


def test_vlm_embeds_raise_naming_the_roadmap_item(ref):
    """The VLM path is ported now: the reduced LLaVA backbone's forward and
    prefill (logits and KV cache) given patch embeddings equal the
    reference's within TOL (``tests/test_torch_models_encdec.py`` holds
    its decode steps too)."""
    jax, jnp = ref.jax, ref.jnp
    jcfg = ref.configs.reduced(ref.configs.get("llava-next-34b"))
    cfg = configs.reduced(configs.get("llava-next-34b"))
    m, jm = Model(cfg), ref.build(jcfg)
    jp = jm.init(jax.random.PRNGKey(4))
    p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 12))
    embeds = (0.02 * rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    jt, je = jnp.asarray(toks, jnp.int32), jnp.asarray(embeds)
    pt, pe = torch.from_numpy(toks), torch.from_numpy(embeds)
    S = cfg.frontend_tokens + toks.shape[1]
    _close((np.asarray(jm.forward(jp, jt, je)),
            m.forward(p, pt, embeds=pe).numpy()))
    jl, jc = jm.prefill(jp, jt, S + 2, embeds=je)
    pl, pc = m.prefill(p, pt, S + 2, embeds=pe)
    assert pc["pos"] == int(jc["pos"]) == S
    _close((np.asarray(jl), pl.numpy()))
    for i in range(cfg.n_layers):
        _close((np.asarray(jc["k"][i]), pc["k"][i].numpy()))
        _close((np.asarray(jc["v"][i]), pc["v"][i].numpy()))
