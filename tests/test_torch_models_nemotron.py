"""The Nemotron-H family (``repro_torch.models.nemotron_h``: Mamba-2,
attention and sigmoid-routed MoE layers in one stack) and the grouped SSD
scan it brought, at a small size on the CPU, against the benchmark's plain
reference (``portbench/reference/nemotron_h.py``, float32, the Mamba-2
paper's minimal chunked SSD, a per-expert loop) on seeded weights. The
reference package has no such family, so nothing here imports it.

  * the reduced configuration (``configs.reduced``: pattern ``ME*EM*``,
    every kind of layer twice, 2 B/C groups, 4 of 8 experts held): the
    full forward, and a prefill then decode steps through the two-kind
    state, against the reference's logits at atol 1e-4 (f32; the two sum
    in other orders, over 6 layers), the prefill's and decode's logits
    against the forward's at 1e-5;
  * the share of experts: 2 shares of 4 and 8 shares of 1, each a layer
    that holds its experts (the router's columns reordered so that the
    share's experts come first, which changes no choice), add up, with the
    shared expert counted once, to the reference's uncut layer (atol
    1e-5), over a prompt (the sorted loop) and one token at a time (the
    decode path's static shapes);
  * the grouped SSD scan (``ssd_scan_plain``, ``ssd_decode_step`` with B
    and C ``[.., g, n]``) equal to a loop over the groups of the
    one-group form, and the shared form ``[.., n]`` taken as one group,
    against a float64 recurrence;
  * the specs, the parameter count, and the serve engine: its counters,
    and the SSD scratch kept while any loaded endpoint runs the kernel;
  * on a CUDA card (``gpu``, skipped elsewhere): the grouped bf16 SSD
    kernel against the plain version at Nemotron-3-Nano's shape; the
    one-group kernel equal bit for bit to the kernel over g identical
    groups at Mamba-2-2.7B's shape; the endpoint's graph decode equal to
    eager decode through ``ServeEngine``, bit for bit.
"""
import dataclasses
import math

import pytest
import torch

from portbench import weights
from portbench.reference import nemotron_h as R
from repro_torch import configs
from repro_torch.kernels import ssd_scan as S
from repro_torch.models import moe
from repro_torch.models.mamba2 import ssd_decode_step
from repro_torch.models.model import Model, TensorSpec, n_params
from repro_torch.serving import engine as port_engine
from repro_torch.serving import registry as port_registry

ARCH = "nemotron-3-nano-30b-a3b-ep8"
INIT = {"embed_std": 1.0, "qk_gain": 2.0, "bias_std": 0.1,
        "norm_jitter": 0.1}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(**kw):
    return configs.reduced(configs.get(ARCH)).with_(**kw)


def _group(cfg):
    m = dataclasses.asdict(cfg)
    m["block_pattern"] = list(m["block_pattern"])
    return m


def _seeded(cfg, seed=3):
    """The program's parameters holding the benchmark's draw, and the
    reference's fetch of the same weights."""
    m = _group(cfg)
    config = {"model": m, "init": INIT,
              "params_module": "repro_torch.models.nemotron_h."
                               "NemotronHParams"}
    layout = R.param_layout(m)
    params = weights.program_params(config, layout, seed, 0, "cpu")
    groups = dict(layout)

    def fetch(group):
        return {n: t.float() for n, t in weights.draw_group(
            groups[group], INIT, m["n_layers"], seed, 0, group,
            "cpu").items()}
    return m, params, fetch


def test_small_config_has_every_kind_twice():
    cfg = _small()
    for kind in "ME*":
        assert cfg.layer_pattern.count(kind) >= 2
    assert (cfg.ssm_groups, cfg.n_held, cfg.n_experts) == (2, 4, 8)
    full = configs.get(ARCH)
    assert full.layer_pattern.count("M") == 23
    assert full.layer_pattern.count("E") == 23
    assert full.layer_pattern.count("*") == 6
    assert (full.d_inner, full.n_ssm_heads, full.n_held) == (4096, 64, 16)
    assert configs.get("nemotron-3-nano-30b-a3b").n_held == 128
    assert ARCH not in configs.ARCHS          # the reference has no such arch


def test_prefill_then_decode_matches_forward_and_reference():
    cfg = _small()
    m, params, fetch = _seeded(cfg)
    model = Model(cfg)
    S_, new = 40, 6
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (1, S_ + new), generator=g)
    with torch.inference_mode():
        full = model.forward(params, tokens)[0]
        ref = R.forward_logits(m, fetch, [(tokens[0], S_)],
                               [torch.arange(S_ + new)])[0]
        torch.testing.assert_close(full, ref, atol=1e-4, rtol=1e-4)
        logits, state = model.prefill(params, tokens[:, :S_], S_ + new)
        assert state["pos"].dim() == 0 and int(state["pos"]) == S_
        assert len(state["k"]) == 2 and len(state["ssm"]) == 2
        torch.testing.assert_close(logits[0, 0], full[S_ - 1], atol=1e-5,
                                   rtol=1e-5)
        for j in range(new):
            logits, state = model.decode_step(params, tokens[:, S_ + j],
                                              state)
            torch.testing.assert_close(logits[0], full[S_ + j], atol=1e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(logits[0], ref[S_ + j], atol=1e-4,
                                       rtol=1e-4)


def test_wrong_gated_norm_moves_the_logits():
    """The published gated norm (gate first, then per group) is what the
    reference holds the program to: the port's Mamba-2 default (norm over
    the whole width, then gate) in its place misses the reference."""
    m, params, fetch = _seeded(_small())
    tokens = torch.randint(0, 512, (1, 32), generator=torch.Generator()
                           .manual_seed(1))
    with torch.inference_mode():
        ref = R.forward_logits(m, fetch, [(tokens[0], 32)],
                               [torch.arange(32)])[0]
        got = Model(_small(ssm_norm="norm_gate")).forward(params, tokens)[0]
    assert float((got - ref).abs().max()) > 1e-2


@pytest.mark.parametrize("share", [4, 1])
def test_held_shares_add_up_to_the_uncut_layer(share):
    E, D = 8, 64
    cfg = _small(experts_held=share)
    m = dict(_group(cfg), experts_held=E)
    g = torch.Generator().manual_seed(11)
    w = {"layers.1.moe.router.w": torch.randn(D, E, generator=g) / 8,
         "layers.1.moe.e_bias": 0.1 * torch.randn(E, generator=g),
         "layers.1.moe.wi": torch.randn(E, D, 32, generator=g) / 8,
         "layers.1.moe.wo": torch.randn(E, 32, D, generator=g) / 6,
         "layers.1.moe.shared.wi.w": torch.randn(D, 48, generator=g) / 8,
         "layers.1.moe.shared.wo.w": torch.randn(48, D, generator=g) / 7}
    x = torch.randn(24, D, generator=g)
    want = R._moe(m, w, "layers.1.", x, lambda a, b: a @ b)
    shared = R._moe(dict(m, experts_held=0, n_experts=E), dict(
        w, **{"layers.1.moe.wi": w["layers.1.moe.wi"][:0],
              "layers.1.moe.wo": w["layers.1.moe.wo"][:0]}),
        "layers.1.", x, lambda a, b: a @ b)
    for path in ("prompt", "token"):
        total = torch.zeros_like(x)
        for k in range(E // share):
            perm = torch.roll(torch.arange(E), -k * share)
            p = moe.DroplessMoE(cfg)
            with torch.no_grad():
                p.router.w.copy_(w["layers.1.moe.router.w"][:, perm])
                p.e_bias.copy_(w["layers.1.moe.e_bias"][perm])
                p.wi.copy_(w["layers.1.moe.wi"][perm[:share]])
                p.wo.copy_(w["layers.1.moe.wo"][perm[:share]])
                p.shared.wi.w.copy_(w["layers.1.moe.shared.wi.w"])
                p.shared.wo.w.copy_(w["layers.1.moe.shared.wo.w"])
                if path == "prompt":
                    y = moe.dropless_apply(cfg, p, x[None])[0]
                else:
                    y = moe.dropless_apply(cfg, p, x[:, None])[:, 0]
            total += y - shared
        torch.testing.assert_close(total + shared, want, atol=1e-5,
                                   rtol=1e-5)


def test_gathered_held_experts_equal_every_held_expert(monkeypatch):
    """One token with the kernels on (top 2, 4 of 8 held: B * top_k < 8,
    the router's experts, up to B = 3): ``expert_gather_plain`` in the
    relu² form, a choice of an expert not held weighted 0, equals the
    every-held-expert product with a one-hot combine (written out here, in
    f32), and the layer equals the kernels-off layer; at B = 4 (8 choices,
    not fewer than the 8 experts) the gathered path does not run."""
    from repro_torch.kernels import expert_gather as EG
    cfg = _small(use_kernels=True)
    H, D = cfg.n_held, cfg.d_model
    p = moe.DroplessMoE(cfg)
    p.init_(torch.Generator().manual_seed(2))
    x = torch.randn(4, 1, D, generator=torch.Generator().manual_seed(5))
    calls = []
    real = EG.expert_gather_plain
    monkeypatch.setattr(EG, "expert_gather_plain",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        xf = x[:1, 0]
        idx, w = moe.route_topk(cfg, p, xf)
        held = idx < H
        assert bool(held.any()) and not bool(held.all())
        c = (torch.nn.functional.one_hot(torch.where(held, idx, H), H + 1)
             [..., :H] * w[..., None]).sum(1)
        h = torch.square(torch.relu(torch.matmul(xf, p.wi)))      # [H,T,F]
        want = (torch.matmul(h, p.wo) * c.t()[..., None]).sum(0)
        got = real(xf, idx, torch.where(held, w, 0.0), p.wi, None, p.wo)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        off = cfg.with_(use_kernels=False)
        for B, runs in ((1, 1), (3, 1), (4, 0)):
            calls.clear()
            y = moe.dropless_apply(cfg, p, x[:B])
            assert len(calls) == runs
            torch.testing.assert_close(y, moe.dropless_apply(off, p, x[:B]),
                                       atol=1e-5, rtol=1e-5)


def _scan_inputs(b, l, h, p, g, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=gen)
    dt = 0.5 * torch.rand(b, l, h, generator=gen) + 0.05
    A = -2.0 * torch.rand(h, generator=gen) - 0.05
    B = torch.randn(b, l, g, n, generator=gen)
    C = torch.randn(b, l, g, n, generator=gen)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [(2, 48, 6, 4, 3, 5, 16),
                                               (1, 64, 8, 8, 2, 16, 64),
                                               (1, 100, 4, 4, 4, 8, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_grouped_plain_scan_matches_a_loop_over_groups(b, l, h, p, g, n,
                                                       chunk, with_state):
    x, dt, A, B, C = _scan_inputs(b, l, h, p, g, n)
    S0 = torch.randn(b, h, n, p) if with_state else None
    y, s = S.ssd_scan_plain(x, dt, A, B, C, chunk, S0)
    r = h // g
    for k in range(g):
        hs = slice(k * r, (k + 1) * r)
        y1, s1 = S.ssd_scan_plain(
            x[:, :, hs], dt[:, :, hs], A[hs], B[:, :, k], C[:, :, k], chunk,
            None if S0 is None else S0[:, hs].contiguous())
        torch.testing.assert_close(y[:, :, hs], y1, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(s[:, hs], s1, atol=1e-5, rtol=1e-5)


def test_grouped_decode_step_matches_a_loop_over_groups():
    b, h, p, g, n = 2, 6, 4, 3, 5
    gen = torch.Generator().manual_seed(2)
    St = torch.randn(b, h, n, p, generator=gen)
    x = torch.randn(b, h, p, generator=gen)
    dt = torch.rand(b, h, generator=gen)
    A = -torch.rand(h, generator=gen)
    B, C = (torch.randn(b, g, n, generator=gen) for _ in range(2))
    y, s = ssd_decode_step(St, x, dt, A, B, C)
    r = h // g
    for k in range(g):
        hs = slice(k * r, (k + 1) * r)
        y1, s1 = ssd_decode_step(St[:, hs], x[:, hs], dt[:, hs], A[hs],
                                 B[:, k], C[:, k])
        torch.testing.assert_close(y[:, hs], y1, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(s[:, hs], s1, atol=1e-6, rtol=1e-6)


def _recurrence_f64(x, dt, A, B, C, S0):
    """S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T, y_t = C_t . S_t, token
    by token in float64, B and C [b, l, n] shared by every head."""
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    S_ = S0.double()
    ys = []
    for t in range(x.shape[1]):
        S_ = S_ * torch.exp(dt[:, t] * A)[..., None, None] + \
            B[:, t, None, :, None] * (dt[:, t, :, None] * x[:, t])[:, :, None]
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S_))
    return torch.stack(ys, 1), S_


def test_one_group_is_the_shared_form():
    """Mamba-2's B and C [b, l, n] are one group: the scan and the decode
    step take them as [b, l, 1, n] and give the same values, and both hold
    to a float64 recurrence token by token."""
    x, dt, A, B, C = _scan_inputs(2, 64, 4, 8, 1, 16, seed=4)
    S0 = torch.randn(2, 4, 16, 8, generator=torch.Generator().manual_seed(5))
    y, s = S.ssd_scan_plain(x, dt, A, B[:, :, 0], C[:, :, 0], 16, S0)
    y1, s1 = S.ssd_scan_plain(x, dt, A, B, C, 16, S0)
    assert torch.equal(y1, y) and torch.equal(s1, s)
    want_y, want_s = _recurrence_f64(x, dt, A, B[:, :, 0], C[:, :, 0], S0)
    torch.testing.assert_close(y.double(), want_y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s.double(), want_s, atol=1e-4, rtol=1e-4)
    yd, sd = ssd_decode_step(s, x[:, 0], dt[:, 0], A, B[:, 0, 0], C[:, 0, 0])
    yd1, sd1 = ssd_decode_step(s, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    assert torch.equal(yd1, yd) and torch.equal(sd1, sd)
    wy, ws = _recurrence_f64(x[:, :1], dt[:, :1], A, B[:, :1, 0],
                             C[:, :1, 0], s)
    torch.testing.assert_close(yd.double(), wy[:, 0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sd.double(), ws, atol=1e-5, rtol=1e-5)


def test_check_cuda_args_takes_groups():
    b, l, h, p, g, n = 1, 32, 8, 16, 4, 16
    xbc = torch.zeros(b, l, h * p + 2 * g * n, dtype=torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    C = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt, A = torch.ones(b, l, h), -torch.ones(h)
    S._check_cuda_args(x, dt, A, B, C, 16, None)
    S._check_cuda_args(x, dt, A, B, C, 16, torch.zeros(b, h, n, p))
    with pytest.raises(ValueError, match="dividing"):
        S._check_cuda_args(x[:, :, :6], dt[..., :6], A[:6], B, C, 16, None)
    with pytest.raises(ValueError):
        S._check_cuda_args(x, dt, A, B, C[..., :1, :], 16, None)


def test_specs_and_parameter_counts():
    cfg = configs.get(ARCH)
    model = Model(cfg)
    cache = model.cache_specs(3, 40)
    assert len(cache["k"]) == len(cache["v"]) == 6
    assert len(cache["ssm"]) == len(cache["conv"]) == 23
    assert cache["k"][0] == TensorSpec((3, 40, 2, 128), torch.bfloat16)
    assert cache["ssm"][0] == TensorSpec((3, 64, 128, 64), torch.float32)
    assert cache["conv"][0] == TensorSpec((3, 3, 4096 + 2 * 8 * 128),
                                          torch.bfloat16)
    assert cache["pos"] == 0
    # held: 23 Mamba-2 (38.7M), 6 attention (23.4M), 23 MoE (16 experts,
    # router, shared), embedding and head: the 5.87B of one card's share
    assert n_params(cfg) == 5_874_032_640
    assert n_params(configs.get("nemotron-3-nano-30b-a3b")) == 31_576_989_696
    small = configs.reduced(cfg)
    m = Model(small)
    p = m.init(0, "cpu")
    vectors = sum(t.numel() for n, t in p.named_parameters()
                  if t.dim() == 1 or n.endswith("conv_w"))
    assert m.param_count(p) == n_params(small) + vectors
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("small", 24, 2, "decode")
    inputs = m.make_inputs(shape, seed=0, device="cpu")
    assert tuple(inputs["token"].shape) == (2,)
    assert not any(bool(t.any()) for t in inputs["cache"]["ssm"])
    loss = m.loss(p, {"tokens": torch.randint(0, 512, (2, 16)),
                      "labels": torch.randint(0, 512, (2, 16))})
    assert loss.shape == () and torch.isfinite(loss)


def _engine(cfgs):
    reg = port_registry.Registry()
    for i, cfg in enumerate(cfgs):
        reg.register(port_registry.ModelEndpoint(f"app-{i}", cfg, seed=i))
    return port_engine.ServeEngine(reg, device="cpu")


def test_unload_keeps_the_ssd_scratch_while_an_ssd_endpoint_is_loaded(
        monkeypatch):
    """A Mamba-2 and a Nemotron-H endpoint (both run the SSD kernel), and a
    dense one (it does not): the scratch goes only when the last of the
    first two is unloaded, in either order."""
    released = []
    monkeypatch.setattr(S, "release_scratch",
                        lambda device=None: released.append(device))
    ssm = configs.reduced(configs.get("mamba2-2.7b")).with_(use_kernels=True)
    hyb = _small(use_kernels=True)
    dense = configs.reduced(configs.get("qwen2-7b")).with_(use_kernels=True)
    ssd = lambda cfg: "ssd_launches" in Model(cfg).counters()
    assert ssd(ssm) and ssd(hyb) and not ssd(dense)
    assert not ssd(hyb.with_(layer_pattern="EE**EE"))
    for order in (("app-0", "app-1"), ("app-1", "app-0")):
        eng = _engine([ssm, hyb, dense])
        for app in ("app-0", "app-1", "app-2"):
            eng.load(app)
        released.clear()
        eng.unload("app-2")
        eng.unload(order[0])
        assert released == []
        eng.unload(order[1])
        assert len(released) == 1


def test_generate_reports_the_counters():
    cfg = _small()
    eng = _engine([cfg])
    eng.load("app-0")
    tokens = torch.randint(0, cfg.vocab, (1, 32))
    held0 = moe.HELD_CHOICES
    out, _ = eng.generate("app-0", tokens, max_new=4, max_len=40)
    times = eng.last_times
    assert out.shape == (1, 4)
    # 2 MoE layers, 32 tokens, top 2 of 8 with 4 held
    assert times["held_choices"] == moe.HELD_CHOICES - held0
    assert 0 < times["held_choices"] <= 2 * 32 * 2
    entry = eng._executables("app-0", 40, 1)
    want = 2 * 2 * 40 * 2 * 16 * 4 + 2 * (4 * 16 * 16 * 4 + 3 * 128 * 4)
    assert times["state_bytes"] == want == sum(
        t.numel() * t.element_size() for k in ("k", "v", "ssm", "conv")
        for t in entry.state[k])
    assert times["ssd_launches"] == 0      # the plain scan on the CPU
    # other families: the counters of the work they have
    # one-token steps through the gathered experts: the plain version on
    # the CPU counts no kernel call
    assert times["expert_gather_launches"] == 0
    # the attention layers' append: the plain chain on the CPU
    assert times["rope_append_launches"] == 0
    rope = {"rope_append_launches"}
    for other, has in (("qwen2-7b", rope), ("mamba2-2.7b", {"ssd_launches"}),
                       ("olmoe-1b-7b", {"expert_gather_launches"} | rope)):
        cfg = configs.reduced(configs.get(other)).with_(use_kernels=True)
        eng = _engine([cfg])
        eng.load("app-0")
        eng.generate("app-0", tokens, max_new=2, max_len=40)
        assert set(eng.last_times) == {"prefill_s", "decode_s",
                                       "state_bytes"} | has
        entry = eng._executables("app-0", 40, 1)
        assert eng.last_times["state_bytes"] == sum(
            t.numel() * t.element_size() for k in ("k", "v", "ssm", "conv")
            for t in entry.state.get(k, ()))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _model_like(b, l, h, p, g, n, dev, seed):
    """x, B and C as views into one conv output [b, l, h p + 2 g n] bf16, as
    the model hands them over; dt and A as its draw gives them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    di = h * p
    xbc = torch.randn(b, l, di + 2 * g * n, generator=gen,
                      device=dev).bfloat16()
    x = xbc[..., :di].reshape(b, l, h, p)
    B = xbc[..., di:di + g * n].unflatten(-1, (g, n))
    C = xbc[..., di + g * n:].unflatten(-1, (g, n))
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device=dev) - 1)
    A = -torch.exp(torch.randn(h, generator=gen, device=dev))
    return x, dt, A, B, C


@pytest.mark.gpu
def test_grouped_bf16_kernel_matches_plain_version():
    """Nemotron-3-Nano's Mamba-2 shape (h 64, p 64, g 8, n 128, Q 128) at
    the mix's shortest and longest prompts, and a ragged length with an
    initial state: the bf16 gate of ``tests/test_torch_kernel_ssd.py``
    (y rounded to bf16: rtol 8e-3, atol 1e-3 of the largest |y|; the f32
    final state within 1e-4 of its largest magnitude)."""
    dev = _card()
    for b, l, with_state in ((1, 512, False), (1, 4096, False),
                             (2, 1000, True)):
        x, dt, A, B, C = _model_like(b, l, 64, 64, 8, 128, dev, l)
        S0 = torch.randn(b, 64, 128, 64, device=dev) if with_state else None
        before = S.LAUNCHES
        y, s = S.ssd_scan(x, dt, A, B, C, chunk=128, initial_state=S0)
        want_y, want_s = S.ssd_scan_plain(x, dt, A, B, C, 128, S0)
        torch.cuda.synchronize()
        assert S.LAUNCHES == before + 1
        torch.testing.assert_close(
            y.float(), want_y, rtol=8e-3,
            atol=1e-3 * max(1.0, float(want_y.abs().max())))
        assert float((s - want_s).abs().max()) <= \
            1e-4 * float(want_s.abs().max())
        # one group's operands swapped with the next's misses the gate
        wrong, _ = S.ssd_scan_plain(x, dt, A, torch.roll(B, 1, dims=2),
                                    torch.roll(C, 1, dims=2), 128, S0)
        assert float((wrong - y.float()).abs().max()) > \
            1e-3 * float(want_y.abs().max()) + 8e-3 * float(
                want_y.abs().max())
    # f32 inputs: the four passes against the plain version
    x, dt, A, B, C = (t.float() for t in _model_like(1, 640, 16, 64, 4, 32,
                                                    dev, 9))
    y, s = S.ssd_scan(x, dt, A, B, C, chunk=128)
    want_y, want_s = S.ssd_scan_plain(x, dt, A, B, C, 128)
    torch.testing.assert_close(y, want_y, atol=5e-5, rtol=5e-4)
    torch.testing.assert_close(s, want_s, atol=5e-5, rtol=5e-4)


@pytest.mark.gpu
def test_one_group_kernel_equals_identical_groups_bit_for_bit():
    """Mamba-2-2.7B's shape (b 2, l 4096, h 80, p 64, n 128, Q 256): the
    kernel over B and C [b, l, n] (the path Mamba-2 takes, unchanged)
    equals, bit for bit, the kernel over g = 8 identical groups [b, l, 8,
    n], whose output blocks take their heads group by group."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, l, h, p, n = 2, 4096, 80, 64, 128
    xbc = torch.randn(b, l, h * p + 2 * n, generator=gen,
                      device=dev).bfloat16()
    x = xbc[..., :h * p].reshape(b, l, h, p)
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn(b, l, h, generator=gen, device=dev) - 1)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    y1, s1 = S.ssd_scan(x, dt, A, B, C, chunk=256)
    Bg = B[:, :, None].expand(b, l, 8, n).contiguous()
    Cg = C[:, :, None].expand(b, l, 8, n).contiguous()
    y8, s8 = S.ssd_scan(x, dt, A, Bg, Cg, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(y1, y8) and torch.equal(s1, s8)


@pytest.mark.gpu
def test_graph_decode_equals_eager_through_the_engine():
    """The reduced configuration in bf16 with the kernels (prompt 128: the
    SSD and flash kernels run): ``generate``'s tokens, through the entry's
    captured decode graph, equal the eager greedy loop's from the same
    prefill, bit for bit, twice; the request's SSD launches are counted
    (one a Mamba-2 layer), and its gathered-expert calls (one a MoE layer
    a decode step)."""
    dev = _card()
    cfg = _small(use_kernels=True, dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("app-0", cfg, seed=5))
    eng = port_engine.ServeEngine(reg, device=dev)
    eng.load("app-0")
    params, model = eng._loaded["app-0"], eng._model(cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 128), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3))
    new, max_len = 9, 144
    with torch.inference_mode():
        lg, state = model.prefill(params, tokens, max_len)
        tok = torch.argmax(lg, dim=-1)[:, 0]
        want = [tok]
        for _ in range(new - 1):
            lg, state = model.decode_step(params, tok, state)
            tok = torch.argmax(lg, dim=-1)
            want.append(tok)
    want = torch.stack(want, dim=1)
    for _ in range(2):
        out, _ = eng.generate("app-0", tokens, max_new=new, max_len=max_len)
        assert torch.equal(out, want)
        assert eng.last_times["ssd_launches"] == 2
        assert eng.last_times["held_choices"] > 0
        # batch 1, top 2 of 4 held: each step's 2 MoE layers gathered
        assert eng.last_times["expert_gather_launches"] == 2 * (new - 1)
    assert eng._executables("app-0", max_len, 1).graph is not None
    eng.unload("app-0")
    assert math.isfinite(float(lg.float().abs().max()))
