"""The plain references against the program at small sizes on the CPU: the
decoder's logits against the port's prefill and decode steps on the
benchmark's draw of the weights, and the keep-alive replay against the
port's warm pool driven as the invoker drives it."""
import types

import numpy as np
import pytest
import torch

from portbench import cell, check, weights
from portbench.reference import decoder, pool as pool_ref
from portbench.tests import tiny


@pytest.mark.parametrize("name,kernels", [("qwen2-7b", True),
                                          ("qwen2-7b", False),
                                          ("olmoe-1b-7b", True)])
def test_decoder_matches_the_program(name, kernels):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import build
    cfg = tiny.config(name)
    m = dict(cfg["model"], use_kernels=kernels)
    cfg["model"] = m
    layout = decoder.param_layout(m)
    seed, S, steps = 2 ** 36 + 3, 128, 4
    params = weights.program_params(cfg, layout, seed, 1, "cpu")
    model = build(ModelConfig(**m))
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, m["vocab"], (1, S), generator=gen)
    fed = torch.randint(0, m["vocab"], (steps,), generator=gen)
    with torch.inference_mode():
        logits, state = model.prefill(params, prompt, S + steps)
        got = [logits[0, -1]]
        for tok in fed[:-1]:
            lg, state = model.decode_step(params, tok[None], state)
            got.append(lg[0])
    got = torch.stack(got)
    groups = dict(layout)

    def fetch(group):
        return {n: t.float() for n, t in weights.draw_group(
            groups[group], cfg["init"], m["n_layers"], seed, 1, group,
            "cpu").items()}

    seq = torch.cat([prompt[0], fed[:-1]])
    want = decoder.forward_logits(m, fetch, [(seq, S)],
                                  [torch.arange(S - 1, S + steps - 1)])[0]
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-4 * float(want.abs().max()),
                          rtol=1e-4)


def test_moe_capacity_drops_in_the_reference():
    """At the small size the prompt's groups overflow some experts: the
    reference drops those choices as the configuration states."""
    m = tiny.config("olmoe-1b-7b")["model"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, m["d_model"], generator=gen)
    router = torch.randn(m["d_model"], m["n_experts"], generator=gen) * 0.5
    idx, val, kept = decoder._route(m, x, router)
    C = int(m["moe_capacity_factor"] * m["top_k"] * 64 / m["n_experts"])
    assert not bool(kept.all())
    for g in range(2):
        per = torch.bincount(idx[g][kept[g]], minlength=m["n_experts"])
        assert int(per.max()) <= C
    assert torch.allclose(val.sum(-1), torch.ones(2, 64))


class FakeEngine:
    """The engine's surface the invoker mirrors onto."""

    def __init__(self):
        self.loaded = set()
        self.last_times = {}

    def is_loaded(self, app):
        return app in self.loaded

    def load(self, app):
        self.loaded.add(app)
        return 0.0

    def unload(self, app):
        self.loaded.discard(app)

    def generate(self, app, tokens, max_new, max_len):
        assert app in self.loaded
        return torch.zeros(1, max_new, dtype=torch.int64), 0.0


def arrivals(rng, n):
    """Three endpoints: a hot one (seconds), a periodic one (about 30 min,
    jittered: the histogram pre-warms it) and one mostly past the 4-hour
    range, merged by time."""
    out = []
    for e, draw in enumerate([lambda: rng.exponential(20.0),
                              lambda: 60 * (30 + rng.normal(0, 0.6)),
                              lambda: 60 * rng.choice([20, 300, 400, 3])]):
        t = 0.0
        for _ in range(n):
            t += max(draw(), 1.0)
            out.append((t, e))
    return sorted(out)


POLICIES = [{"kind": "fixed", "keep_alive_minutes": 10.0},
            dict(tiny.mix("code-warm")["policy"])]


@pytest.mark.parametrize("policy", POLICIES, ids=["fixed", "hybrid"])
@pytest.mark.parametrize("images", [3, 1])
def test_pool_replay_matches_the_warm_pool(policy, images):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import ModelEndpoint, Registry, WarmPool
    rng = np.random.default_rng(11)
    apps = [f"m-{e}" for e in range(3)]
    reg = Registry()
    mcfg = ModelConfig(**tiny.config("qwen2-7b")["model"])
    for e, app in enumerate(apps):
        reg.register(ModelEndpoint(app, mcfg, seed=e, weight_bytes=1000))
    wp = WarmPool(reg, cell._policy_spec(policy), budget_bytes=1000 * images)
    inv = cell.Invoker(FakeEngine(), wp, apps, 64, traced=False)
    inv.host_bytes = {a: 1 for a in apps}
    served = []
    for i, (t, e) in enumerate(arrivals(rng, 40)):
        q = types.SimpleNamespace(index=i, app=e, arrival_s=t, prompt=1,
                                  new=1)
        served.append((q, inv.serve(q, None)))
    fake = types.SimpleNamespace(traffic={"endpoints": 3, "policy": policy})
    assert check.pool_mismatches(fake, served, inv.actions, 1000,
                                 1000 * images) == 0
    colds = sum(r["cold"] for _, r in served)
    assert 0 < colds < len(served)
    if policy["kind"] == "hybrid":
        assert wp.stats.prewarms > 0
    if images == 1:
        assert wp.stats.evictions > 0
    # a verdict flipped, or an action dropped, is seen
    served[5][1]["cold"] = not served[5][1]["cold"]
    assert check.pool_mismatches(fake, served, inv.actions, 1000,
                                 1000 * images) == 1
    served[5][1]["cold"] = not served[5][1]["cold"]
    assert check.pool_mismatches(fake, served, inv.actions[1:], 1000,
                                 1000 * images) == 1


def test_replay_refuses_arima():
    with pytest.raises(NotImplementedError):
        pool_ref.replay([(0, 0.0)], 1, {"kind": "hybrid", "use_arima": True},
                        [1], 1)
