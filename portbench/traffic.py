"""The one traffic generator: turns a mix's parameters (``traffic/<name>.json``)
and a seed into the requests a cell serves, in arrival order.

A mix names a distribution for the prompt length, the new tokens and each
endpoint's gaps between arrivals (``log_uniform`` over [low, high],
``uniform`` over [low, high], ``exponential`` of a mean, in virtual
seconds). Every seed does the same work: a block of ``block`` (prompt,
new) pairs at the quantiles ``(i + 0.5) / block`` of both distributions,
paired by the fixed stride ``pair_stride``, is served over and over. The
block, sorted by size, is cut into groups of ``swap`` neighbouring pairs,
served in a fixed order that keeps the work (prompt and new tokens) of
every prefix of the block close to its share; the seed orders the pairs
inside each group, draws each endpoint's gaps (the same quantiles of their
distribution, each block shuffled), and with them which endpoint serves
which request, and draws the tokens. A closed loop's window ends after a
part of a block, so a shuffled block would change the window's work from
seed to seed (a 45-s window holds about 50 cold requests).

Prompt lengths are rounded to the configuration's ``prompt_multiple`` (the
program's shape rule: the attention kernel takes prompts of whole 128-row
tiles, the mixture of experts whole routing groups) and kept so that a
request fits the model's context and the mix's ``max_len``. Token ids are
uniform over the vocabulary, drawn on the device from a seed of their own
for each request.
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
from typing import Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["Request", "quantile", "pairs", "groups", "requests", "warmups",
           "prompt_tokens", "prompt_lengths"]


@dataclasses.dataclass(frozen=True)
class Request:
    index: int            # position in the stream (warm-ups are negative)
    app: int              # endpoint
    arrival_s: float      # virtual seconds
    prompt: int           # prompt tokens
    new: int              # tokens to generate (the first from the prefill)
    token_seed: int


def quantile(dist: dict, u: float) -> float:
    """The ``u`` quantile of ``dist``."""
    kind = dist["dist"]
    if kind == "log_uniform":
        return dist["low"] * (dist["high"] / dist["low"]) ** u
    if kind == "uniform":
        return dist["low"] + u * (dist["high"] - dist["low"])
    if kind == "exponential":
        return -dist["mean"] * math.log1p(-u)
    raise ValueError(f"unknown distribution {kind!r}")


def _levels(traffic: dict) -> List[float]:
    K = traffic["block"]
    return [(i + 0.5) / K for i in range(K)]


def _new_tokens(traffic: dict, u: float) -> int:
    d = traffic["new_tokens"]
    return int(min(max(round(quantile(d, u)), d["low"]), d["high"]))


def prompt_lengths(traffic: dict, config: dict) -> Tuple[int, int, int]:
    """(multiple, shortest, longest) prompt the cell may send."""
    q = config["prompt_multiple"]
    d = traffic["prompt_tokens"]
    room = min(traffic["max_len"], config["max_position_embeddings"]) \
        - traffic["new_tokens"]["high"] + 1
    lo = -(-d["low"] // q) * q
    hi = min(d["high"], room) // q * q
    if hi < lo:
        raise ValueError(f"no prompt length fits: [{lo}, {hi}]")
    return q, lo, hi


def _prompt(traffic: dict, config: dict, u: float) -> int:
    q, lo, hi = prompt_lengths(traffic, config)
    return int(min(max(round(quantile(traffic["prompt_tokens"], u) / q) * q,
                       lo), hi))


def pairs(traffic: dict, config: dict) -> List[Tuple[int, int]]:
    """The block's (prompt, new) pairs, the same for every seed."""
    us = _levels(traffic)
    K, a = len(us), traffic["pair_stride"]
    if math.gcd(K, a) != 1:
        raise ValueError("pair_stride must be prime to block")
    return [(_prompt(traffic, config, us[i]),
             _new_tokens(traffic, us[(i * a) % K])) for i in range(K)]


def _token_seed(seed: int, index: int) -> int:
    h = hashlib.blake2b(f"tokens/{seed}/{index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def warmups(traffic: dict, config: dict, seed: int) -> List[Request]:
    """One request a endpoint at virtual time 0, at the block's longest
    prompt and most new tokens (set-up, not measured)."""
    block = pairs(traffic, config)
    S = max(p for p, _ in block)
    n = max(k for _, k in block)
    return [Request(-1 - e, e, 0.0, S, n, _token_seed(seed, -1 - e))
            for e in range(traffic["endpoints"])]


def groups(traffic: dict, config: dict) -> List[List[Tuple[int, int]]]:
    """The block's groups of ``swap`` neighbouring pairs (by size), in the
    order served: each next group the one that brings the work served so
    far closest to its share (ties to the smaller group)."""
    block = sorted(pairs(traffic, config))
    g = traffic["swap"]
    grps = [block[i:i + g] for i in range(0, len(block), g)]
    work = [sum(p + n for p, n in grp) for grp in grps]
    share = sum(work) / len(work)
    left, done, order = list(range(len(grps))), 0, []
    for k in range(len(grps)):
        i = min(left, key=lambda i: (abs(done + work[i] - (k + 1) * share),
                                     i))
        left.remove(i)
        done += work[i]
        order.append(grps[i])
    return order


def requests(traffic: dict, config: dict, seed: int) -> Iterator[Request]:
    """The endless stream of requests after the warm-ups, in arrival order;
    the same for the same seed."""
    rng = np.random.Generator(np.random.PCG64(seed))
    grps = groups(traffic, config)
    gaps = [quantile(traffic["gap_s"], u) for u in _levels(traffic)]
    E = traffic["endpoints"]
    pending = [[] for _ in range(E)]

    def next_gap(e):
        if not pending[e]:
            pending[e] = [gaps[i] for i in rng.permutation(len(gaps))]
        return pending[e].pop()

    heap = [(next_gap(e), e) for e in range(E)]
    heapq.heapify(heap)
    order: List[Tuple[int, int]] = []
    index = 0
    while True:
        if not order:
            order = [grp[i] for grp in grps
                     for i in rng.permutation(len(grp))][::-1]
        t, e = heapq.heappop(heap)
        heapq.heappush(heap, (t + next_gap(e), e))
        S, n = order.pop()
        yield Request(index, e, t, S, n, _token_seed(seed, index))
        index += 1


def prompt_tokens(req: Request, vocab: int, device) -> torch.Tensor:
    """The request's prompt [1, S] (int64), uniform over the vocabulary."""
    gen = torch.Generator(device=device).manual_seed(req.token_seed)
    return torch.randint(0, vocab, (1, req.prompt), generator=gen,
                         device=device)
