"""The port's SSM model (``repro_torch.models.mamba2``) end to end against the
reference's, on the same weights.

Config: ``reduced(get("mamba2-2.7b"))`` — 2 layers, d_model 64, d_inner
128, 8 heads of 16, state 16, chunk 16, conv width 4, vocab 512. The
weights come from the reference's ``Model.init`` and cross through
``interop.model_params_from_numpy``.

  * ``kernels``: f32, ``use_kernels=True``, S=64 — a multiple of the chunk,
    so the reference runs its Pallas SSD kernel (in interpret mode) and
    the port its kernel branch (on the CPU, the kernel's plain version);
  * ``plain``: f32, ``use_kernels=False``, S=24 — the plain branches, with
    an effective chunk of 12 (the largest divisor of 24 up to 16);
  * ``bf16``: bf16, ``use_kernels=True``, S=64.

Compared: ``prefill``'s last-token logits and both state leaves of every
layer (``ssm`` [B,H,N,P] f32 and ``conv`` [B,W-1,DI+2N]), four
teacher-forced ``decode_step``s, and ``forward``. f32 within atol = rtol =
5e-5: the scans and the matrix products sum in another order than XLA's,
through two layers. bf16: 99% of the elements within atol = rtol = 2e-2
(the reference's bf16 kernel tolerance) and every element within 5e-2:
the two frameworks round to bf16 after different operations (XLA on the
CPU computes bf16 elementwise chains in f32), and a value near a rounding
edge lands one bf16 ulp apart and carries on.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import Model, build, mamba2

CASES = {"kernels": (True, 64, "float32"), "plain": (False, 24, "float32"),
         "bf16": (True, 64, "bfloat16")}
TOL = {"float32": 5e-5, "bfloat16": 2e-2}
BF16_ALL_WITHIN = 5e-2       # every bf16 element; TOL for 99% of them
DECODE_STEPS = 4
N_LAYERS = 2


def _cfg(use_kernels, dtype, get, reduced):
    return reduced(get("mamba2-2.7b")).with_(use_kernels=use_kernels,
                                             dtype=dtype)


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


@pytest.fixture(scope="module")
def runs(ref):
    """Both models' outputs per case, computed once per case."""
    jax, jnp = ref.jax, ref.jnp
    done = {}

    def run(name):
        if name in done:
            return done[name]
        use_kernels, S, dtype = CASES[name]
        jcfg = _cfg(use_kernels, dtype, ref.configs.get, ref.configs.reduced)
        cfg = _cfg(use_kernels, dtype, configs.get, configs.reduced)
        assert cfg.n_layers == N_LAYERS
        jm, m = ref.build(jcfg), build(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
        rng = np.random.default_rng(S + use_kernels)
        tokens = rng.integers(0, cfg.vocab, (2, S))
        nxt = rng.integers(0, cfg.vocab, (DECODE_STEPS, 2))
        f32 = lambda x: np.asarray(x, np.float32)
        t32 = lambda x: x.float().numpy()

        jl, jc = jax.jit(jm.prefill, static_argnums=2)(
            jp, jnp.asarray(tokens, jnp.int32), S + DECODE_STEPS)
        pl, pc = m.prefill(p, torch.from_numpy(tokens))
        out = {"prefill": (f32(jl), t32(pl)), "state": {}, "decode": []}
        for i in range(N_LAYERS):
            for k in ("ssm", "conv"):
                out["state"][f"{k}{i}"] = (f32(jc[k][i]), t32(pc[k][i]))
        assert int(jc["pos"]) == pc["pos"] == S
        jdec = jax.jit(jm.decode_step)
        for s in range(DECODE_STEPS):
            jl, jc = jdec(jp, jnp.asarray(nxt[s], jnp.int32), jc)
            pl, pc = m.decode_step(p, torch.from_numpy(nxt[s]), pc)
            out["decode"].append((f32(jl), t32(pl)))
        for i in range(N_LAYERS):
            out["decode"].append((f32(jc["ssm"][i]), t32(pc["ssm"][i])))
        if dtype == "float32":
            out["forward"] = (f32(jax.jit(jm.forward)(
                jp, jnp.asarray(tokens, jnp.int32))),
                t32(m.forward(p, torch.from_numpy(tokens))))
        done[name] = SimpleNamespace(tol=TOL[dtype], **out)
        return done[name]

    return run


def _close(pair, tol):
    want, got = pair
    assert want.shape == got.shape
    if tol == TOL["float32"]:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    np.testing.assert_allclose(got, want, atol=BF16_ALL_WITHIN, rtol=0)
    within = np.abs(got - want) <= tol + tol * np.abs(want)
    assert within.mean() >= 0.99, f"{within.mean():.4f} within {tol}"


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_logits(runs, case):
    r = runs(case)
    assert r.prefill[1].shape == (2, 1, 512)
    _close(r.prefill, r.tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("leaf", [f"{k}{i}" for i in range(N_LAYERS)
                                  for k in ("ssm", "conv")])
def test_prefill_state(runs, case, leaf):
    r = runs(case)
    _close(r.state[leaf], r.tol)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps(runs, case):
    r = runs(case)
    for pair in r.decode:
        _close(pair, r.tol)


@pytest.mark.parametrize("case", ["kernels", "plain"])
def test_forward(runs, case):
    r = runs(case)
    _close(r.forward, r.tol)
    # the prefill's last-token logits are forward's last row
    np.testing.assert_allclose(r.prefill[1][:, 0], r.forward[1][:, -1],
                               atol=1e-5, rtol=1e-5)


def test_init_follows_the_reference_distributions(ref):
    """Shapes equal the reference's tree; zero conv_b and dt_bias, unit D
    and scales, A_log = log(linspace(1, 16, H)); the normal draws have the
    reference's scales (checked statistically: a torch.Generator does not
    give jax.random's numbers)."""
    cfg = configs.reduced(configs.get("mamba2-2.7b"))
    jcfg = ref.configs.reduced(ref.configs.get("mamba2-2.7b"))
    p = Model(cfg).init(seed=3, device="cpu")
    assert isinstance(p, mamba2.SSMParams)
    shapes = ref.jax.eval_shape(ref.build(jcfg).init,
                                ref.jax.random.PRNGKey(0))
    flat = {}
    for path, leaf in ref.jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        if keys[0] == "layers":
            for i in range(leaf.shape[0]):
                flat[".".join(["layers", str(i)] + keys[1:])] = leaf.shape[1:]
        else:
            flat[".".join(keys)] = leaf.shape
    got = {n: tuple(t.shape) for n, t in p.named_parameters()}
    assert got == {n: tuple(s) for n, s in flat.items()}
    H = cfg.n_ssm_heads
    for name, t in p.named_parameters():
        leaf = name.rpartition(".")[2]
        if leaf in ("scale", "D"):
            assert torch.all(t == 1.0)
        elif leaf in ("conv_b", "dt_bias"):
            assert torch.all(t == 0.0)
        elif leaf == "A_log":
            np.testing.assert_allclose(
                t.numpy(), np.log(np.linspace(1.0, 16.0, H)), rtol=1e-6)
        else:
            scale = {"table": 0.02, "conv_w": 0.1}.get(
                leaf, 1.0 / np.sqrt(t.shape[0]))
            assert abs(float(t.std()) / scale - 1.0) < 0.1, name
    q = Model(cfg).init(seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 q.parameters()))


def test_interop_rejects_an_ssm_tree_that_does_not_fit(ref):
    cfg = configs.reduced(configs.get("mamba2-2.7b"))
    jcfg = ref.configs.reduced(ref.configs.get("mamba2-2.7b"))

    def tree():
        return ref.jax.device_get(
            ref.build(jcfg).init(ref.jax.random.PRNGKey(1)))

    t = tree()
    p = model_params_from_numpy(cfg, t, device="cpu")
    np.testing.assert_array_equal(p.layers[1].in_proj.w.numpy(),
                                  t["layers"]["in_proj"]["w"][1])
    np.testing.assert_array_equal(p.layers[0].A_log.numpy(),
                                  t["layers"]["A_log"][0])
    t = tree()
    del t["layers"]["dt_bias"]
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(cfg, t, device="cpu")
    t = tree()
    t["layers"]["extra"] = t["layers"]["D"]
    with pytest.raises(ValueError, match="extra"):
        model_params_from_numpy(cfg, t, device="cpu")
    t = tree()
    t["layers"]["conv_w"] = t["layers"]["conv_w"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        model_params_from_numpy(cfg, t, device="cpu")


def test_init_state_matches_what_prefill_returns():
    cfg = configs.reduced(configs.get("mamba2-2.7b"))
    p = Model(cfg).init(seed=0, device="cpu")
    zero = mamba2.init_state(cfg, 2, torch.float32, device="cpu")
    _, st = mamba2.prefill(cfg, p, torch.zeros((2, 16), dtype=torch.long))
    assert zero["pos"] == 0 and st["pos"] == 16
    for k in ("ssm", "conv"):
        assert [t.shape for t in zero[k]] == [t.shape for t in st[k]]
        assert [t.dtype for t in zero[k]] == [t.dtype for t in st[k]]
    # decode from the zero state equals a one-token prefill
    tok = torch.tensor([3, 7])
    lg, _ = mamba2.decode_step(cfg, p, tok, zero)
    want, _ = mamba2.prefill(cfg, p, tok[:, None])
    torch.testing.assert_close(lg, want[:, 0], atol=1e-5, rtol=1e-5)
