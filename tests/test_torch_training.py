"""The port's training path (losses, AdamW, data, the train step) against
the reference's, on the same weights, batches and gradients.

Configs are the reduced ones (2 layers, width 128, f32, no remat; the
hybrid 3 layers). The weights come from the reference's ``Model.init``
and cross through ``interop``; batches from ``training.data.batch_at``
(pure numpy in both packages, equal bit for bit).

  * ``Model.loss`` within rtol 1e-5 of the reference's for every family
    (dense tied and untied, MoE with its weighted aux loss, Mamba-2,
    RG-LRU, encoder-decoder, the VLM backbone), with ``chunked_xent`` off
    and on where the family reads it, and with a mask;
  * the gradients of ``torch.autograd.grad`` against ``jax.grad``'s,
    carried across leaf by leaf: atol 1e-5 x max|g| plus rtol 1e-4 (the
    sums of the backward run in another order than XLA's). Mamba-2 against
    the reference with its SSD's mask moved before the ``exp`` (as the
    port computes it): the reference as it stands gives NaN gradients
    (ROADMAP Queue C), which ``test_mamba2_grads_finite_where_reference_nan``
    shows;
  * ``softmax_xent_chunked`` across several chunks, both table layouts;
  * ``apply_updates`` on the same numpy gradients: params, m and v within
    rtol 1e-6 (one f32 rounding of the update), the schedule, the global
    norm and the decay rule the reference's stacked layout implies;
  * the whole train step as a loss trajectory over 5 steps at rtol 1e-4
    (AdamW's first update is about +-lr x sign(g), so a gradient near 0
    whose sign differs moves a parameter by 2 lr: parameters after a step
    are not comparable, losses are), and with ``cast_bf16`` within one bf16
    rounding step (rtol 1e-2);
  * the model kernels refuse to be differentiated through, on the CPU as
    on the card, and pass under ``inference_mode``.
"""
import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.interop import model_params_from_numpy, \
    train_state_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.training import data, optimizer as opt
from repro_torch.training.train_loop import to_device

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4   # atol as a share of max |g|
STEP_RTOL = 1e-4
BF16_RTOL = 1e-2
OPT_RTOL = 1e-6
# the families and, for those whose loss reads them, chunked_xent and mask
LOSS_CASES = [(a, v) for a in ("smollm-135m", "qwen2-7b",
                               "seamless-m4t-medium", "llava-next-34b")
              for v in ("plain", "chunked", "masked")] + \
    [(a, v) for a in ("olmoe-1b-7b", "mamba2-2.7b", "recurrentgemma-2b")
     for v in ("plain", "masked")]
LOSS_IDS = [f"{a}-{v}" for a, v in LOSS_CASES]


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
        from repro import configs as jconfigs
        from repro.launch import steps as jsteps
        from repro.models import build as jbuild
        from repro.models import layers as jlayers
        from repro.training import data as jdata
        from repro.training import optimizer as jopt
        yield SimpleNamespace(jax=jax, jnp=jax.numpy, configs=jconfigs,
                              build=jbuild, layers=jlayers, data=jdata,
                              opt=jopt, steps=jsteps)


def _shape(cfg, seq=32, batch=2):
    if cfg.frontend == "vision":
        seq += cfg.frontend_tokens
    return dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                               global_batch=batch)


def _cfgs(ref, arch, **kw):
    jcfg = ref.configs.reduced(ref.configs.get(arch)).with_(**kw)
    cfg = configs.reduced(configs.get(arch)).with_(**kw)
    return jcfg, cfg


def _jbatch(ref, batch):
    return {k: ref.jnp.asarray(v) for k, v in batch.items()}


def _masked_ssd_reference(jax, jnp):
    """The reference's ``models/mamba2.py::ssd_reference`` with one line
    changed: the causal mask applied to the exponent (``-inf`` above the
    diagonal) instead of to ``exp(seg)``, whose upper triangle overflows
    to inf and gives ``inf * 0 = NaN`` in the backward. Same values."""
    from repro.models.mamba2 import _effective_chunk

    def ssd(x, dt, A, B, C, chunk, initial_state=None):
        b, l, h, p = x.shape
        n = B.shape[-1]
        chunk = _effective_chunk(l, chunk)
        nc = l // chunk
        xb = x.reshape(b, nc, chunk, h, p)
        dtb = dt.reshape(b, nc, chunk, h)
        Bb = B.reshape(b, nc, chunk, n)
        Cb = C.reshape(b, nc, chunk, n)
        cum = jnp.cumsum(dtb * A[None, None, None, :], axis=2)
        CB = jnp.einsum("bcin,bcjn->bcij", Cb, Bb)
        seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        causal = jnp.tril(jnp.ones((chunk, chunk), bool))
        decay = jnp.exp(jnp.where(causal[None, None, :, :, None], seg,
                                  -jnp.inf))
        M = CB[..., None] * decay
        y_intra = jnp.einsum("bcijh,bcjhp->bcihp", M, xb * dtb[..., None])
        last = cum[:, :, -1:, :]
        w = jnp.exp(last - cum)
        S_loc = jnp.einsum("bcjn,bcjh,bcjhp->bchnp", Bb, w * dtb, xb)
        chunk_decay = jnp.exp(last[:, :, 0, :])
        init = (jnp.zeros((b, h, n, p), x.dtype) if initial_state is None
                else initial_state)

        def step(S, inputs):
            dec, S_c = inputs
            return S * dec[..., None, None] + S_c, S

        final, S_in = jax.lax.scan(step, init, (
            jnp.moveaxis(chunk_decay, 1, 0), jnp.moveaxis(S_loc, 1, 0)))
        y_inter = jnp.einsum("bcin,bcih,bchnp->bcihp", Cb, jnp.exp(cum),
                             jnp.moveaxis(S_in, 0, 1))
        return (y_intra + y_inter).reshape(b, l, h, p), final

    return ssd


@pytest.fixture(scope="module")
def repaired_ssd(ref):
    """A context in which the reference's Mamba-2 uses
    :func:`_masked_ssd_reference`."""
    import repro.models.mamba2 as jmamba2
    ssd = _masked_ssd_reference(ref.jax, ref.jnp)

    @contextlib.contextmanager
    def context():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmamba2, "ssd_reference", ssd)
            yield
    return context


def _loss_batch(cfg, variant):
    batch = data.batch_at(3, cfg, _shape(cfg))
    if variant == "masked":
        rng = np.random.default_rng(5)
        batch["mask"] = (rng.uniform(size=batch["labels"].shape)
                         < 0.6).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def losses(ref, repaired_ssd):
    """Loss and gradients of both packages per case, computed once."""
    jax = ref.jax
    done = {}

    def run(arch, variant):
        if (arch, variant) in done:
            return done[arch, variant]
        jcfg, cfg = _cfgs(ref, arch, chunked_xent=variant == "chunked")
        jm, m = ref.build(jcfg), build(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _loss_batch(cfg, variant)
        with repaired_ssd():
            jl, jg = jax.jit(jax.value_and_grad(jm.loss))(
                jp, _jbatch(ref, batch))
        p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
        names, leaves = zip(*p.named_parameters())
        for t in leaves:
            t.requires_grad_(True)
        loss = m.loss(p, to_device(batch, "cpu"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        want = dict(model_params_from_numpy(cfg, jax.device_get(jg),
                                            device="cpu").named_parameters())
        done[arch, variant] = SimpleNamespace(
            want_loss=float(jl), loss=float(loss.detach()), names=names,
            grads=[np.zeros(want[n].shape) if g is None else g.numpy()
                   for n, g in zip(names, grads)],
            want_grads=[want[n].detach().numpy() for n in names])
        return done[arch, variant]

    return run


@pytest.mark.parametrize("arch,variant", LOSS_CASES, ids=LOSS_IDS)
def test_loss_matches_reference(losses, arch, variant):
    r = losses(arch, variant)
    assert np.isfinite(r.loss)
    np.testing.assert_allclose(r.loss, r.want_loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch,variant", LOSS_CASES, ids=LOSS_IDS)
def test_grads_match_jax_grad(losses, arch, variant):
    r = losses(arch, variant)
    for name, got, want in zip(r.names, r.grads, r.want_grads):
        assert np.isfinite(want).all() and np.isfinite(got).all(), name
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_mamba2_grads_finite_where_reference_nan(ref, losses):
    """The reference's Mamba-2 as it stands: NaN gradients (its SSD masks
    ``exp(seg)`` after an upper triangle that overflows); the port's are
    finite and equal the repaired reference's (above)."""
    jax = ref.jax
    jcfg = ref.configs.reduced(ref.configs.get("mamba2-2.7b"))
    jm = ref.build(jcfg)
    batch = _loss_batch(configs.reduced(configs.get("mamba2-2.7b")), "plain")
    _, jg = jax.jit(jax.value_and_grad(jm.loss))(
        jm.init(jax.random.PRNGKey(0)), _jbatch(ref, batch))
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jg))
    r = losses("mamba2-2.7b", "plain")
    assert all(np.isfinite(g).all() for g in r.grads)


@pytest.mark.parametrize("transpose", [False, True], ids=["tied", "head"])
def test_chunked_xent_over_several_chunks(ref, transpose):
    """Chunks of 8 over S=40 (the chunk search lands on 8): value and both
    inputs' gradients against the reference's chunked and plain losses."""
    jax, jnp = ref.jax, ref.jnp
    rng = np.random.default_rng(11)
    B, S, D, V = 2, 40, 16, 50
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    table = rng.normal(size=(D, V) if transpose else (V, D)).astype(
        np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)

    def jloss(x, t):
        return ref.layers.softmax_xent_chunked(x, t, jnp.asarray(labels),
                                               transpose_table=transpose,
                                               chunk=12)
    want, (wgx, wgt) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))
    tx = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = L.softmax_xent_chunked(tx, tt, torch.from_numpy(labels).long(),
                                 transpose_table=transpose, chunk=12)
    gx, gt = torch.autograd.grad(got, (tx, tt))
    logits = tx @ tt if transpose else tx @ tt.T
    plain = L.softmax_xent(logits, torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got.detach()), float(plain.detach()),
                               rtol=LOSS_RTOL)
    for g, w in ((gx, wgx), (gt, wgt)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max())


def _random_like(rng, tree):
    return {k: _random_like(rng, v) if isinstance(v, dict) else
            rng.normal(0, 0.05, np.shape(v)).astype(np.float32)
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ["qwen2-7b", "recurrentgemma-2b"])
def test_apply_updates_matches_reference(ref, arch):
    """Three updates from the same numpy gradients (the second clipped):
    params, m, v, grad_norm and lr agree. qwen2 has QKV biases and per-layer
    norm scales (decayed: stacked in the reference), the hybrid family at 5
    layers two unstacked trailing layers (their vectors not decayed).
    Within rtol 1e-6, or, where a sum cancels, 1e-6 of its scale: ``lr``
    for a parameter, the tensor's largest moment for m and v (the global
    norm sums in another order, so the clip scale differs in its last
    bit)."""
    jax, jnp = ref.jax, ref.jnp
    jcfg, cfg = _cfgs(ref, arch, n_layers=5 if arch == "recurrentgemma-2b"
                      else 2)
    jp = jax.device_get(ref.build(jcfg).init(jax.random.PRNGKey(0)))
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                         grad_clip=1.0)
    jstate = ref.opt.init_state(jax.tree.map(jnp.asarray, jp))
    state = train_state_from_numpy(cfg, jax.device_get(jstate), device="cpu")
    rng = np.random.default_rng(2)
    update = jax.jit(ref.opt.apply_updates, static_argnums=2)
    for k in range(3):
        g = _random_like(rng, jp)
        if k == 1:
            g = jax.tree.map(lambda a: a * 100.0, g)      # clipped
        jstate, jmet = update(jstate, jax.tree.map(jnp.asarray, g), ocfg)
        grads = {n: t.detach() for n, t in model_params_from_numpy(
            cfg, g, device="cpu").named_parameters()}
        state, met = opt.apply_updates(state, grads, ocfg)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                                   rtol=OPT_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=OPT_RTOL)
    want = train_state_from_numpy(cfg, jax.device_get(jstate), device="cpu")
    assert state.step == want.step == 3
    for name, p in want.params.named_parameters():
        got = dict(state.params.named_parameters())[name]
        np.testing.assert_allclose(got.numpy(), p.numpy(), rtol=OPT_RTOL,
                                   atol=OPT_RTOL * ocfg.lr, err_msg=name)
        for field in ("m", "v"):
            w = getattr(want, field)[name].numpy()
            np.testing.assert_allclose(
                getattr(state, field)[name].numpy(), w, rtol=OPT_RTOL,
                atol=OPT_RTOL * np.abs(w).max(), err_msg=f"{field} {name}")


def test_decay_follows_the_reference_layout(ref):
    cfg = configs.reduced(configs.get("recurrentgemma-2b")).with_(n_layers=5)
    d = opt.decays(build(cfg).init(0, "cpu"))
    assert d["blocks.0.rec1.ln.scale"] and d["blocks.0.mlp1.ffn.wi.w"]
    assert d["embed.table"] and d["tail_rec0.wx.w"]
    assert not d["ln_f.scale"] and not d["tail_rec0.ln.scale"]


def test_schedule_and_global_norm(ref):
    jnp = ref.jnp
    ocfg = opt.OptConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    for s in (0, 1, 5, 10, 11, 30, 50, 80):
        want = float(ref.opt._schedule(ocfg, jnp.float32(s)))
        got = float(opt._schedule(ocfg, torch.tensor(s, dtype=torch.float32)))
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL)
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=sh).astype(np.float32)
          for sh in ((3, 4), (7,), (2, 2, 5))]
    np.testing.assert_allclose(
        float(opt.global_norm([torch.from_numpy(x) for x in xs])),
        float(ref.opt.global_norm([jnp.asarray(x) for x in xs])),
        rtol=OPT_RTOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_batches_equal_reference(ref, arch):
    """Every frontend: none, vision (``embeds``, shorter text), encdec."""
    jcfg, cfg = _cfgs(ref, arch)
    shape = _shape(cfg, seq=24, batch=3)
    for step in range(4):
        want = ref.data.batch_at(step, jcfg, shape)
        got = data.batch_at(step, cfg, shape)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = data.batches(cfg, shape, start_step=2)
    np.testing.assert_array_equal(next(got)["tokens"],
                                  data.batch_at(2, cfg, shape)["tokens"])


def _trajectories(ref, arch, cast_bf16, repaired_ssd, steps=5):
    jax = ref.jax
    jcfg, cfg = _cfgs(ref, arch)
    jm, m = ref.build(jcfg), build(cfg)
    ocfg = opt.OptConfig(lr=5e-3, warmup_steps=2, total_steps=steps)
    jstate = ref.opt.init_state(jm.init(jax.random.PRNGKey(0)))
    state = train_state_from_numpy(cfg, jax.device_get(jstate), device="cpu")
    jstep = jax.jit(ref.steps.make_train_step(jm, ocfg, cast_bf16=cast_bf16))
    step = make_train_step(m, ocfg, cast_bf16=cast_bf16)
    shape = _shape(cfg, seq=32, batch=2)
    want, got = [], []
    for s in range(steps):
        batch = data.batch_at(s, cfg, shape)
        with repaired_ssd():
            jstate, jmet = jstep(jstate, _jbatch(ref, batch))
        state, met = step(state, to_device(batch, "cpu"))
        want.append((float(jmet["loss"]), float(jmet["grad_norm"])))
        got.append((float(met["loss"]), float(met["grad_norm"])))
    assert state.step == steps
    return np.array(got), np.array(want)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-2.7b"])
def test_train_step_loss_trajectory(ref, repaired_ssd, arch):
    got, want = _trajectories(ref, arch, False, repaired_ssd)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=STEP_RTOL)


def test_train_step_cast_bf16(ref, repaired_ssd):
    got, want = _trajectories(ref, "smollm-135m", True, repaired_ssd)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL)


def test_train_step_reduces_loss():
    """Twin of the reference's ``tests/test_models.py::
    test_train_step_reduces_loss``: 40 steps of reduced SmolLM."""
    cfg = configs.reduced(configs.get("smollm-135m"))
    model = build(cfg)
    state = opt.init_state(model.init(0, "cpu"))
    shape = _shape(cfg, seq=64, batch=4)
    step_fn = make_train_step(model, opt.OptConfig(lr=5e-3, warmup_steps=5))
    losses = []
    for step in range(40):
        state, metrics = step_fn(state, to_device(
            data.batch_at(step, cfg, shape), "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_steps_reject_what_needs_a_mesh():
    """The ZeRO layout (grad_shardings) needs a state of DTensors on a
    mesh; an unsharded state is refused (tests/test_torch_distributed.py
    runs the step on a mesh)."""
    cfg = configs.reduced(configs.get("smollm-135m"))
    m = build(cfg)
    step = make_train_step(m, opt.OptConfig(), grad_shardings={})
    state = opt.init_state(m.init(0, device="cpu"))
    tok = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="distribute_state"):
        step(state, {"tokens": tok, "labels": tok})


# the four model kernels and their inputs on the CPU (their plain versions)
def _kernel_inputs(name, rng):
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    if name == "flash_attention":
        return lambda *a: ops.flash_attention(*a), \
            (t(1, 128, 2, 16), t(1, 128, 1, 16), t(1, 128, 1, 16))
    if name == "decode_attention":
        return lambda *a: ops.decode_attention(*a, 5), \
            (t(1, 1, 2, 16), t(1, 8, 1, 16), t(1, 8, 1, 16))
    if name == "rglru_scan":
        return ops.rglru_scan, (t(1, 16, 8), torch.rand(1, 16, 8))
    return lambda x, dt, B, C: ops.ssd_scan(
        x, dt, -torch.ones(2), B, C, chunk=8), \
        (t(1, 16, 2, 4), torch.rand(1, 16, 2), t(1, 16, 3), t(1, 16, 3))


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "rglru_scan", "ssd_scan"])
def test_kernels_refuse_autograd(name):
    fn, args = _kernel_inputs(name, np.random.default_rng(0))
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        fn(*args)
    with torch.inference_mode():
        fn(*args)
    with torch.no_grad():
        fn(*args)
    fn(*(a.detach() for a in args))


def test_loss_through_kernel_branch_raises():
    """``use_kernels=True`` at a length the kernel takes (S=128): the loss
    raises instead of training every weight but those feeding the kernel;
    ``use_kernels=False`` trains."""
    cfg = configs.reduced(configs.get("smollm-135m")).with_(use_kernels=True)
    params = build(cfg).init(0, "cpu").requires_grad_(True)
    batch = to_device(data.batch_at(0, cfg, _shape(cfg, seq=128)), "cpu")
    with pytest.raises(RuntimeError, match="flash_attention"):
        build(cfg).loss(params, batch)
    plain = cfg.with_(use_kernels=False)
    assert torch.isfinite(build(plain).loss(params, batch))


def test_prefill_and_serve_steps_match_reference(ref):
    """``make_prefill_step`` and ``make_serve_step``: the greedy tokens of
    a prefill and three decode steps equal the reference's (reduced
    Qwen2, f32, the same weights)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    jax, jnp = ref.jax, ref.jnp
    jcfg, cfg = _cfgs(ref, "qwen2-7b")
    jm, m = ref.build(jcfg), build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    p = model_params_from_numpy(cfg, jax.device_get(jp), device="cpu")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16))
    jtok, jcache = jax.jit(ref.steps.make_prefill_step(jm, 20))(
        jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tok, cache = make_prefill_step(m, 20)(p, {"tokens": torch.from_numpy(
        tokens)})
    assert tok.dtype == torch.int32 and tok.shape == (2, 1)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    jserve, serve = jax.jit(ref.steps.make_serve_step(jm)), \
        make_serve_step(m)
    jtok, tok = jtok[:, 0], tok[:, 0]
    for _ in range(3):
        jtok, jcache = jserve(jp, jtok, jcache)
        tok, cache = serve(p, tok, cache)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert cache["pos"] == 19
