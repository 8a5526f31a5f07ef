"""The rotary-and-append kernel (``repro_torch.kernels.rope_append``): RoPE
of a step's queries and keys and the write of its keys and values into the
layer's KV cache in one launch, the cached self-attention layers' path
under ``use_kernels`` (``layers.attention_apply``).

On the CPU: the plain version equal bit for bit to the model's own chain
(``layers.rope`` on q and k, ``layers.write_rows`` of k and v) at a host
and a device position, rotating and not; ``attention_apply`` taking the
kernel's entry exactly where a cache is given under ``use_kernels`` off
the sequence-sharded route (not in training, cross-attention, with the
kernels off or on the sharded route), with caches equal to the kernels-off
path's; the block and vector arithmetic, the argument checks, and the
refusal of autograd.

On a CUDA card (``gpu``, skipped elsewhere): the kernel's q, ``ck`` and
``cv`` equal the plain chain's on the card bit for bit at Qwen2-7B's heads
(28/4 of 128), OLMoE-1B-7B's (16/16 of 128), Nemotron-H's (32/2 of 128,
no rotation), head dims 64 and 256, and widths whose halves are no power
of two: for prefills (S 128 to 4,096 at position 0) and for decode steps
(S 1 at a device position) captured once in a CUDA graph and replayed over
advancing positions.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import rope_append as RA
from repro_torch.models import layers as L

# (Hq, Hkv, hd, theta, rotate): the serving paths' attention layers
QWEN2 = (28, 4, 128, 1e6, True)
OLMOE = (16, 16, 128, 1e4, True)
NEMOTRON = (32, 2, 128, 1e4, False)
HD64 = (16, 16, 64, 1e4, True)          # SeamlessM4T's decoder
HD256 = (10, 1, 256, 1e4, True)         # RecurrentGemma's heads
HD80 = (8, 2, 80, 1e4, True)            # half 40: no power of two
SHAPES = {"qwen2": QWEN2, "olmoe": OLMOE, "nemotron": NEMOTRON,
          "hd64": HD64, "hd256": HD256, "hd80": HD80}


def _inputs(B, S, Hq, Hkv, hd, L_, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g).to(device, dtype)
    q, k, v = mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd)
    ck, cv = mk(B, L_, Hkv, hd), mk(B, L_, Hkv, hd)
    return q, k, v, ck, cv


def _chain(q, k, v, ck, cv, positions, pos, theta, rotate):
    """The model's plain chain as ``attention_apply`` ran it before the
    kernel: rope of q and k, then write_rows of k and v."""
    if rotate:
        q = L.rope(q, positions, theta)
        k = L.rope(k, positions, theta)
    L.write_rows(ck, pos, k)
    L.write_rows(cv, pos, v)
    return q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rotate", [True, False], ids=["rope", "append"])
@pytest.mark.parametrize("where", ["prefill_host_pos", "decode_device_pos"])
def test_plain_version_is_the_models_chain_bit_for_bit(dtype, rotate, where):
    B, Hq, Hkv, hd, L_ = 2, 4, 2, 16, 12
    if where == "prefill_host_pos":
        S, pos = 5, 3
        positions = (torch.arange(S) + pos).expand(B, S)
    else:
        S, pos = 1, L.device_pos(7, "cpu")
        positions = L.step_positions(pos, B, "cpu")
    q, k, v, ck, cv = _inputs(B, S, Hq, Hkv, hd, L_, dtype, "cpu")
    q0, k0, v0 = q.clone(), k.clone(), v.clone()
    ck1, cv1 = ck.clone(), cv.clone()
    want = _chain(q0.clone(), k0, v0, ck1, cv1, positions, pos, 1e4, rotate)
    n0 = RA.LAUNCHES
    got = RA.rope_append(q, k, v, ck, cv, positions, pos, 1e4, rotate)
    assert RA.LAUNCHES == n0                 # the plain version counts none
    assert got is q and torch.equal(q, want)
    assert torch.equal(ck, ck1) and torch.equal(cv, cv1)
    assert torch.equal(k, k0) and torch.equal(v, v0)   # inputs unchanged
    if not rotate:
        assert torch.equal(q, q0)


def _cfg(**kw):
    return configs.reduced(configs.get("qwen2-7b")).with_(n_layers=1, **kw)


def _attention(cfg, B=2, S=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = L.Attention(cfg)
    with torch.no_grad():
        for prm in p.parameters():
            prm.normal_(generator=g).mul_(0.3)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    return p, x


@pytest.fixture
def counted(monkeypatch):
    """Calls of the kernel's entry from ``attention_apply`` (``kops.
    rope_append``), each run through the real wrapper."""
    calls = []
    real = kops.rope_append

    def wrapped(*args, **kw):
        calls.append(kw.get("rotate", True))
        return real(*args, **kw)

    monkeypatch.setattr(kops, "rope_append", wrapped)
    return calls


@pytest.mark.parametrize("use_rope", [True, False], ids=["rope", "no_rope"])
def test_attention_apply_takes_the_kernel_with_a_cache_under_use_kernels(
        counted, use_rope):
    """Prefill at host position 0 then two decode steps at device
    positions: one kernel entry a call with the kernels on, none with
    them off; the caches and outputs equal the kernels-off path's bit for
    bit wherever the attention itself is the same function (the prefill's
    plain ``_sdpa``: S is not a multiple of 128)."""
    outs, caches = {}, {}
    for use_kernels in (False, True):
        cfg = _cfg(use_kernels=use_kernels)
        p, x = _attention(cfg)
        B, S = x.shape[:2]
        cache = L.make_cache(cfg, B, S + 2, 1, torch.float32, "cpu")
        layer = {"k": cache["k"][0], "v": cache["v"][0], "pos": 0}
        with torch.no_grad():
            out = [L.attention_apply(p, cfg, x, torch.arange(S).expand(B, S),
                                     cache=layer, use_rope=use_rope)]
            pos = L.device_pos(S, "cpu")
            for t in range(2):
                layer["pos"] = pos
                out.append(L.attention_apply(
                    p, cfg, x[:, t:t + 1], L.step_positions(pos, B, "cpu"),
                    cache=layer, use_rope=use_rope))
                pos = pos + 1
        outs[use_kernels], caches[use_kernels] = out, layer
        assert counted == ([use_rope] * 3 if use_kernels else [])
    assert torch.equal(outs[True][0], outs[False][0])
    assert torch.equal(caches[True]["k"], caches[False]["k"])
    assert torch.equal(caches[True]["v"], caches[False]["v"])


def test_attention_apply_keeps_the_plain_chain_elsewhere(counted,
                                                         monkeypatch):
    """No cache (training's full sequence), cross-attention over a memory,
    and the sequence-sharded decode route (its rank-local write takes the
    rotated k) never reach the kernel's entry."""
    cfg = _cfg(use_kernels=True)
    p, x = _attention(cfg)
    B, S = x.shape[:2]
    pos_ids = torch.arange(S).expand(B, S)
    with torch.no_grad():
        L.attention_apply(p, cfg, x, pos_ids)
        L.attention_apply(p, cfg, x, pos_ids, kv_source=x[:, :3])
    seen = {}

    def sharded_decode(q, k, v, ck, cv, pos):
        seen.update(q=q, k=k, pos=pos)
        return torch.zeros_like(q), ck, cv

    monkeypatch.setattr(L.dist_decode, "applicable", lambda Skv, Sq: True)
    monkeypatch.setattr(L.dist_decode, "decode_attention", sharded_decode)
    cache = L.make_cache(cfg, B, S + 1, 1, torch.float32, "cpu")
    layer = {"k": cache["k"][0], "v": cache["v"][0], "pos": S}
    step = L.step_positions(S, B, "cpu")
    with torch.no_grad():
        L.attention_apply(p, cfg, x[:, :1], step, cache=layer)
    assert counted == []
    k = L._heads(L.linear(p.wk, x[:, :1]), cfg.n_kv_heads, cfg.hd)
    assert seen["pos"] == S and torch.equal(
        seen["k"], L.rope(k, step, cfg.rope_theta))


def test_groups_spread_a_decode_step_and_keep_a_prefill_whole():
    assert RA.groups(36, 1, 132) == 36          # Qwen2-7B, batch-1 decode
    assert RA.groups(48, 2, 132) == 48          # OLMoE at batch 2
    assert RA.groups(4, 1, 132) == 4            # Nemotron-H: k and v alone
    assert RA.groups(36, 4096, 132) == 1        # a prefill
    assert RA.groups(36, 8, 132) == 17


def test_vector_width_follows_the_half_and_the_addresses():
    t = lambda n, dt: torch.zeros(n, dtype=dt)
    assert RA._vec(128, [t(64, torch.bfloat16)]) == 8
    assert RA._vec(128, [t(64, torch.float32)]) == 4
    assert RA._vec(80, [t(64, torch.bfloat16)]) == 8
    assert RA._vec(76, [t(64, torch.bfloat16)]) == 2
    assert RA._vec(78, [t(64, torch.float32)]) == 1
    assert RA._vec(128, [t(64, torch.bfloat16)[1:]]) == 1


def test_check_cuda_args_refuses_what_the_kernel_does_not_take():
    B, S, Hq, Hkv, hd, L_ = 1, 2, 4, 2, 16, 8
    args = lambda **kw: dict(zip(
        ("q", "k", "v", "ck", "cv"),
        _inputs(B, S, Hq, Hkv, hd, L_, torch.bfloat16, "cpu")), **kw)
    pos_ids = torch.arange(S).expand(B, S)
    RA._check_cuda_args(positions=pos_ids, pos=0, **args())
    RA._check_cuda_args(positions=pos_ids, pos=L_ - S, **args())
    bad = [
        (dict(pos=L_ - S + 1), "outside the cache"),
        (dict(pos=torch.tensor([1])), "0-d int64"),
        (dict(positions=pos_ids.int()), "int64"),
        (dict(q=torch.zeros(B, S, Hq, hd, dtype=torch.float16)),
         "float32 or bfloat16"),
        (dict(k=torch.zeros(B, S, Hkv, hd)), "contiguous"),
        (dict(cv=torch.zeros(B, L_ + 1, Hkv, hd, dtype=torch.bfloat16)),
         "contiguous"),
        (dict(ck=torch.zeros(B, Hkv, L_, hd, dtype=torch.bfloat16)
              .transpose(1, 2)), "contiguous"),
    ]
    for over, match in bad:
        kw = dict(positions=pos_ids, pos=0, **args())
        kw.update(over)
        with pytest.raises(ValueError, match=match):
            RA._check_cuda_args(**kw)
    odd = _inputs(B, S, Hq, Hkv, 15, L_, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="even"):
        RA._check_cuda_args(*odd, pos_ids, 0)
    wide = _inputs(B, S, 1, 1, 258, L_, torch.bfloat16, "cpu")
    with pytest.raises(ValueError, match="at most 256"):
        RA._check_cuda_args(*wide, pos_ids, 0)


def test_refuses_autograd():
    q, k, v, ck, cv = _inputs(1, 2, 2, 1, 8, 4, torch.float32, "cpu")
    pos_ids = torch.arange(2).expand(1, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        RA.rope_append(q, k.requires_grad_(), v, ck, cv, pos_ids, 0, 1e4)
    with torch.no_grad():
        RA.rope_append(q, k, v, ck, cv, pos_ids, 0, 1e4)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S", [128, 1000, 4096])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_prefill_equals_the_plain_chain_bit_for_bit(shape, S):
    """A prompt of S tokens at position 0 (host), batch 1 (and 2 at S
    1,000), bf16: q, ck and cv equal the plain chain's on the card."""
    dev = _card()
    Hq, Hkv, hd, theta, rotate = SHAPES[shape]
    B, L_ = (2 if S == 1000 else 1), S + 16
    q, k, v, ck, cv = _inputs(B, S, Hq, Hkv, hd, L_, torch.bfloat16, dev,
                              seed=S)
    positions = torch.arange(S, device=dev).expand(B, S)
    q1, ck1, cv1 = q.clone(), ck.clone(), cv.clone()
    want = _chain(q1, k, v, ck1, cv1, positions, 0, theta, rotate)
    n0 = RA.LAUNCHES
    got = RA.rope_append(q, k, v, ck, cv, positions, 0, theta, rotate)
    torch.cuda.synchronize()
    assert RA.LAUNCHES == n0 + 1
    assert torch.equal(got, want), shape
    assert torch.equal(ck, ck1) and torch.equal(cv, cv1), shape


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES))
def test_decode_graph_over_advancing_positions_equals_the_plain_chain(shape):
    """One decode step (S 1, batch 1, the position a 0-d device tensor as
    the serve engine's state holds it) captured once in a CUDA graph and
    replayed at 12 successive positions from 4,090, fresh q, k and v
    copied in before each replay: q and both caches equal the plain
    chain's, stepped eagerly on its own copy, after every replay; the
    capture counts one launch, the replays none."""
    dev = _card()
    Hq, Hkv, hd, theta, rotate = SHAPES[shape]
    B, L_, start, steps = 1, 4112, 4090, 12
    q, k, v, ck, cv = _inputs(B, 1, Hq, Hkv, hd, L_, torch.bfloat16, dev)
    ck1, cv1 = ck.clone(), cv.clone()
    pos = L.device_pos(start, dev)
    # an eager call first (the library's build and load stay out of the
    # capture), on copies
    RA.rope_append(q.clone(), k, v, ck.clone(), cv.clone(),
                   L.step_positions(pos, B, dev), pos, theta, rotate)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = RA.LAUNCHES
    with torch.cuda.graph(graph):
        RA.rope_append(q, k, v, ck, cv, L.step_positions(pos, B, dev), pos,
                       theta, rotate)
    assert RA.LAUNCHES == n0 + 1
    for step in range(steps):
        new = _inputs(B, 1, Hq, Hkv, hd, L_, torch.bfloat16, dev,
                      seed=100 + step)[:3]
        for buf, t in zip((q, k, v), new):
            buf.copy_(t)
        p1 = L.device_pos(start + step, dev)
        want = _chain(new[0].clone(), new[1], new[2], ck1, cv1,
                      L.step_positions(p1, B, dev), p1, theta, rotate)
        graph.replay()
        pos.add_(1)
        torch.cuda.synchronize()
        assert torch.equal(q, want), (shape, step)
        assert torch.equal(ck, ck1) and torch.equal(cv, cv1), (shape, step)
    assert RA.LAUNCHES == n0 + 1
    del graph


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [78, 80, 128])
def test_f32_kernel_equals_the_plain_chain_bit_for_bit(hd):
    """f32 at loads of 1 (hd 78), 4 (80) and 4 elements (128), batch 2,
    rows from position 9 (a host int)."""
    dev = _card()
    B, S, Hq, Hkv, L_ = 2, 37, 6, 3, 64
    q, k, v, ck, cv = _inputs(B, S, Hq, Hkv, hd, L_, torch.float32, dev,
                              seed=hd)
    positions = (torch.arange(S, device=dev) + 9).expand(B, S)
    q1, ck1, cv1 = q.clone(), ck.clone(), cv.clone()
    want = _chain(q1, k, v, ck1, cv1, positions, 9, 1e4, True)
    got = RA.rope_append(q, k, v, ck, cv, positions, 9, 1e4, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(ck, ck1) \
        and torch.equal(cv, cv1)
