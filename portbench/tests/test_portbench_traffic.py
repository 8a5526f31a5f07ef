"""The generator: one seed gives the same requests, another seed the same
sizes and gaps in another order; lengths keep to the program's shapes."""
import collections
import itertools
import json

import pytest
import torch

from portbench import traffic as T
from portbench.tests import tiny

CELLS = [(w["config"], w["traffic"]) for w in tiny.BENCH["workloads"]]


def files(config, mix):
    pb = tiny.ROOT / "portbench"
    return (json.loads((pb / "configs" / f"{config}.json").read_text()),
            json.loads((pb / "traffic" / f"{mix}.json").read_text()))


def first(mix, cfg, seed, n):
    return list(itertools.islice(T.requests(mix, cfg, seed), n))


@pytest.mark.parametrize("config,mix", CELLS)
def test_same_seed_same_requests(config, mix):
    cfg, t = files(config, mix)
    seed = 2 ** 33 + 5
    assert first(t, cfg, seed, 300) == first(t, cfg, seed, 300)
    req = first(t, cfg, seed, 1)[0]
    a = T.prompt_tokens(req, cfg["model"]["vocab"], "cpu")
    assert torch.equal(a, T.prompt_tokens(req, cfg["model"]["vocab"], "cpu"))
    assert a.shape == (1, req.prompt)
    assert 0 <= int(a.min()) and int(a.max()) < cfg["model"]["vocab"]


@pytest.mark.parametrize("config,mix", CELLS)
def test_other_seed_same_work_other_order(config, mix):
    cfg, t = files(config, mix)
    K = t["block"]
    a, b = first(t, cfg, 7, 4 * K), first(t, cfg, 2 ** 35 + 11, 4 * K)
    sizes = lambda rs: collections.Counter((r.prompt, r.new) for r in rs)
    assert sizes(a) == sizes(b)
    assert [(r.prompt, r.new) for r in a] != [(r.prompt, r.new) for r in b]
    assert a[0].token_seed != b[0].token_seed
    # every prefix does nearly the same work: it differs by at most the
    # pairs of one group, which are neighbours in size
    grps = T.groups(t, cfg)
    step = max(max(p + n for p, n in g) - min(p + n for p, n in g)
               for g in grps)
    work = lambda rs, k: sum(r.prompt + r.new for r in rs[:k])
    assert all(abs(work(a, k) - work(b, k)) <= step for k in range(len(a)))
    # each endpoint's gaps: the same quantiles in every seed, reordered
    for e in range(t["endpoints"]):
        def gaps(rs):
            times = [0.0] + [r.arrival_s for r in rs if r.app == e]
            return sorted(round(y - x, 9) for x, y in zip(times, times[1:]))
        ga, gb = gaps(first(t, cfg, 7, 40 * K)), gaps(first(t, cfg, 9, 40 * K))
        n = min(len(ga), len(gb)) // K * K
        full = lambda g: collections.Counter(g[:n])
        assert len(set(ga)) == K and set(ga) == set(gb)
        assert n > 0 and full(sorted(ga)) .keys() == full(sorted(gb)).keys()


@pytest.mark.parametrize("config,mix", CELLS)
def test_lengths_keep_the_programs_shapes(config, mix):
    cfg, t = files(config, mix)
    q, lo, hi = T.prompt_lengths(t, cfg)
    for r in first(t, cfg, 3, 200) + T.warmups(t, cfg, 3):
        assert r.prompt % cfg["prompt_multiple"] == 0 and lo <= r.prompt <= hi
        assert t["new_tokens"]["low"] <= r.new <= t["new_tokens"]["high"]
        assert r.prompt + r.new - 1 <= min(t["max_len"],
                                          cfg["max_position_embeddings"])
    arrivals = [r.arrival_s for r in first(t, cfg, 3, 200)]
    assert arrivals == sorted(arrivals) and arrivals[0] > 0


def test_quantiles():
    assert T.quantile({"dist": "log_uniform", "low": 4, "high": 32}, 0.5) \
        == pytest.approx(8 * 2 ** 0.5)
    assert T.quantile({"dist": "uniform", "low": 900, "high": 3600}, 0.25) \
        == 1575
    assert T.quantile({"dist": "exponential", "mean": 5.0}, 0.5) \
        == pytest.approx(5.0 * 0.6931471805599453)
