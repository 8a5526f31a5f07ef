"""The gathered-expert kernel (``repro_torch.kernels.expert_gather``): the
MoE layer's experts on the chosen (token, expert) pairs only, the one-token
decode step of OLMoE's GShard layer (``swiglu``) and Nemotron-H's held
experts (``relu2``).

On the CPU: the plain version against a loop over the pairs written out
here, its dead pairs (weight 0, an id past the experts) left unread even
where their weights are NaN, the split arithmetic at the two serving
shapes, the argument checks, and the refusal of autograd.

On a CUDA card (``gpu``, skipped elsewhere): the kernel against the plain
version in bf16 at OLMoE-1B-7B's shape (D 2,048, F 1,024, 64 experts, top
8) and Nemotron-3-Nano's (D 2,688, F 1,856, 16 held of 128, top 6), and in
f32 at a ragged shape; two runs equal bit for bit; every unchosen expert
filled with NaN leaving y finite and unchanged; and a reduced OLMoE
endpoint's graph decode equal to eager decode through ``ServeEngine``, the
request's kernel calls counted (one a MoE layer a step).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels import expert_gather as EG
from repro_torch.serving import engine as port_engine
from repro_torch.serving import registry as port_registry

# (T, k, E, D, F, experts the router covers or None: E): OLMoE-1B-7B's
# decode at batch 1 and 2, Nemotron-3-Nano's (16 experts held; its router
# here over 32, so that about half the choices are held: ids >= 16 weigh 0)
OLMOE = (1, 8, 64, 2048, 1024, None)
OLMOE_B2 = (2, 8, 64, 2048, 1024, None)
NEMOTRON = (1, 6, 16, 2688, 1856, 32)
# bf16 kernel vs plain: both accumulate in f32 and round h and y to bf16 at
# the same places; the sums run in other orders, so an h near a rounding
# edge can round one step apart (2^-8 of it) and y can land one bf16 step
# (2^-8 relative: rtol 8e-3) from the plain version's, plus the f32
# orders' drift, far below 1e-3 of the largest |y| (atol).
BF16_TOL = (1e-3, 8e-3)


def _inputs(T, k, E, D, F_, share, dtype, device, seed=0, gated=True):
    """Tokens, choices and weights of a routed layer: top k of a random
    router over ``share`` (or E) experts, the weights renormalised; a
    choice past the E experts of this device weighs 0, as the dropless
    layer passes it. Experts at 1/sqrt(fan-in), x at unit scale."""
    g = torch.Generator().manual_seed(seed)
    n = share or E
    gates = torch.softmax(torch.randn(T, n, generator=g), -1)
    w, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = torch.where(ids < E, w / w.sum(-1, keepdim=True), 0.0)
    x = torch.randn(T, D, generator=g)
    wi = torch.randn(E, D, F_, generator=g) / D ** 0.5
    wg = torch.randn(E, D, F_, generator=g) / D ** 0.5 if gated else None
    wo = torch.randn(E, F_, D, generator=g) / F_ ** 0.5
    to = lambda t: None if t is None else t.to(device, dtype)
    return (to(x), ids.to(device), w.to(device), to(wi), to(wg), to(wo))


def _loop(x, ids, w, wi, wg, wo):
    """The routed term pair by pair, in f64, h rounded to x's dtype."""
    T, k = ids.shape
    y = torch.zeros(T, x.shape[1], dtype=torch.float64)
    for t in range(T):
        for j in range(k):
            e = int(ids[t, j])
            if float(w[t, j]) == 0.0 or not 0 <= e < wi.shape[0]:
                continue
            xt = x[t].double()
            u = xt @ wi[e].double()
            h = torch.square(F.relu(u)) if wg is None else \
                F.silu(xt @ wg[e].double()) * u
            h = h.to(x.dtype).double()
            y[t] += float(w[t, j]) * (h @ wo[e].double())
    return y


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "relu2"])
def test_plain_version_is_the_loop_over_pairs(gated):
    x, ids, w, wi, wg, wo = _inputs(3, 3, 6, 32, 24, 12, torch.float32,
                                    "cpu", gated=gated)
    assert bool((w == 0).any()) and bool((w != 0).any())
    got = EG.expert_gather_plain(x, ids, w, wi, wg, wo)
    assert got.dtype == torch.float32 and got.shape == (3, 32)
    torch.testing.assert_close(got.double(), _loop(x, ids, w, wi, wg, wo),
                               atol=1e-5, rtol=1e-5)


def test_plain_version_reads_no_dead_pair():
    """Every expert no live pair chose, and a dead pair's id past the
    experts, hold NaN: y stays finite and equal to the clean run's."""
    x, ids, w, wi, wg, wo = _inputs(2, 4, 8, 32, 16, 12, torch.float32,
                                    "cpu", seed=4)
    w[0, 1] = 0.0                     # a choice dropped by capacity
    ids[1, 3] = 40                    # an id past the experts, weight kept
    want = EG.expert_gather_plain(x, ids, w, wi, wg, wo)
    live = (w != 0) & (ids < 8)
    chosen = torch.zeros(8, dtype=torch.bool)
    chosen[ids[live]] = True
    for t in (wi, wg, wo):
        t[~chosen] = float("nan")
    got = EG.expert_gather_plain(x, ids, w, wi, wg, wo)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


def test_splits_cover_the_card_at_the_serving_shapes():
    # a lone live pair's blocks cover 132 SMs: OLMoE's up pass 16 tiles of
    # 64 columns x 8 splits of 256 rows, its down pass 32 x 4 splits of 256
    assert EG.splits(16, 2048, 132) == 8
    assert EG.splits(32, 1024, 132) == 4
    # Nemotron's: 29 x 8 splits of 336 rows, 42 x 4 splits of 464
    assert EG.splits(29, 2688, 132) == 8
    assert EG.splits(42, 1856, 132) == 4
    # enough tiles: one split; rows past MAX_SPLIT_ROWS always split
    assert EG.splits(256, 2048, 132) == 1
    assert EG.splits(256, 3 * EG.MAX_SPLIT_ROWS, 132) == 3
    # never under MIN_SPLIT_ROWS rows a split
    assert EG.splits(1, 300, 132) == 1


def test_check_cuda_args_refuses_what_the_kernel_does_not_take():
    x, ids, w, wi, wg, wo = _inputs(1, 2, 4, 64, 32, None, torch.bfloat16,
                                    "cpu")
    EG._check_cuda_args(x, ids, w, wi, wg, wo)
    EG._check_cuda_args(x, ids, w, wi, None, wo)
    bad = {"x dtype": (x.half(), ids, w, wi, wg, wo),
           "wi width": (x, ids, w, wi[:, :32], wg, wo),
           "wo shape": (x, ids, w, wi, wg, wo.transpose(1, 2)),
           "wg dtype": (x, ids, w, wi, wg.float(), wo),
           "ids rows": (x, ids[:0], w[:0], wi, wg, wo),
           "w shape": (x, ids, w[:, :1], wi, wg, wo),
           "x strided": (torch.zeros(1, 128, dtype=torch.bfloat16)[:, ::2],
                         ids, w, wi, wg, wo)}
    for what, args in bad.items():
        with pytest.raises(ValueError):
            EG._check_cuda_args(*args)
            pytest.fail(what)
    x4, ids4, w4, wi4, wg4, wo4 = _inputs(1, 2, 4, 60, 32, None,
                                          torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="multiples of 8"):
        EG._check_cuda_args(x4, ids4, w4, wi4, wg4, wo4)


def test_refuses_autograd():
    x, ids, w, wi, wg, wo = _inputs(1, 2, 4, 16, 8, None, torch.float32,
                                    "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        EG.expert_gather(x, ids, w, wi.requires_grad_(), wg, wo)
    with torch.no_grad():
        EG.expert_gather(x, ids, w, wi, wg, wo)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _close_bf16(got, want):
    atol = BF16_TOL[0] * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=BF16_TOL[1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [OLMOE, OLMOE_B2, NEMOTRON],
                         ids=["olmoe", "olmoe-b2", "nemotron"])
def test_kernel_matches_plain_version_bit_for_bit_across_runs(shape):
    dev = _card()
    T, k, E, D, F_, share = shape
    args = _inputs(T, k, E, D, F_, share, torch.bfloat16, dev,
                   gated=share is None)
    form = "relu2" if share else "swiglu"
    n0, f0 = EG.LAUNCHES, EG.LAUNCHES_BY_FORM[form]
    got = EG.expert_gather(*args)
    again = EG.expert_gather(*args)
    torch.cuda.synchronize()
    assert (EG.LAUNCHES, EG.LAUNCHES_BY_FORM[form]) == (n0 + 2, f0 + 2)
    assert got.dtype == torch.bfloat16 and got.shape == (T, D)
    assert torch.equal(got, again)
    _close_bf16(got, EG.expert_gather_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "relu2"])
def test_f32_kernel_at_ragged_tiles_matches_plain_version(gated):
    """f32 (32-column tiles) at D and F that are not whole tiles, three
    tokens with a dropped choice and an id past the experts."""
    dev = _card()
    x, ids, w, wi, wg, wo = _inputs(3, 3, 5, 136, 72, 7, torch.float32, dev,
                                    seed=2, gated=gated)
    w[0, 0] = 0.0
    got = EG.expert_gather(x, ids, w, wi, wg, wo)
    torch.testing.assert_close(got, EG.expert_gather_plain(
        x, ids, w, wi, wg, wo), atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [OLMOE, NEMOTRON], ids=["olmoe",
                                                          "nemotron"])
def test_kernel_reads_no_unchosen_expert(shape):
    """Every expert that no live pair chose holds NaN (and, at OLMoE's
    shape, a chosen expert of a pair weighted 0 as capacity drops it): y
    is finite and equal, bit for bit, to the run on clean weights."""
    dev = _card()
    T, k, E, D, F_, share = shape
    x, ids, w, wi, wg, wo = _inputs(T, k, E, D, F_, share, torch.bfloat16,
                                    dev, seed=1, gated=share is None)
    if share is None:
        w[0, k - 1] = 0.0
    want = EG.expert_gather(x, ids, w, wi, wg, wo)
    live = (w != 0) & (ids < E)
    chosen = torch.zeros(E, dtype=torch.bool, device=dev)
    chosen[ids[live]] = True
    assert not bool(chosen.all())
    for t in (wi, wg, wo):
        if t is not None:
            t[~chosen] = float("nan")
    got = EG.expert_gather(x, ids, w, wi, wg, wo)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.gpu
def test_olmoe_graph_decode_equals_eager_through_the_engine():
    """Reduced OLMoE in bf16 with the kernels at batch 1 (top 2 of 8: the
    gathered path): ``generate``'s tokens, through the entry's captured
    decode graph, equal the eager greedy loop's bit for bit, twice, and
    each request counts one kernel call a MoE layer a decode step."""
    dev = _card()
    cfg = configs.reduced(configs.get("olmoe-1b-7b")).with_(
        use_kernels=True, dtype="bfloat16")
    reg = port_registry.Registry()
    reg.register(port_registry.ModelEndpoint("app-0", cfg, seed=5))
    eng = port_engine.ServeEngine(reg, device=dev)
    eng.load("app-0")
    params, model = eng._loaded["app-0"], eng._model(cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 128), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(3))
    new, max_len = 9, 144
    n0 = EG.LAUNCHES
    with torch.inference_mode():
        lg, state = model.prefill(params, tokens, max_len)
        tok = torch.argmax(lg, dim=-1)[:, 0]
        want = [tok]
        for _ in range(new - 1):
            lg, state = model.decode_step(params, tok, state)
            tok = torch.argmax(lg, dim=-1)
            want.append(tok)
    torch.cuda.synchronize()
    assert EG.LAUNCHES - n0 == cfg.n_layers * (new - 1)
    want = torch.stack(want, dim=1)
    for _ in range(2):
        out, _ = eng.generate("app-0", tokens, max_new=new, max_len=max_len)
        assert torch.equal(out, want)
        assert eng.last_times["expert_gather_launches"] == \
            cfg.n_layers * (new - 1)
    assert eng._executables("app-0", max_len, 1).graph is not None
    eng.unload("app-0")
