"""The comparison that decides ``correct``.

Two numbers, each with its limit (the configuration file's ``correct``
group), and the count of failed requests (limit 0):

  * ``logit_gap_mean``: for a sample of the window's completed requests,
    drawn from the seed with the longest request always in it, until it
    holds ``sample_tokens`` served tokens: the plain reference runs once
    over each prompt followed by its served tokens (float32, TF32 off, on
    the benchmark's own draw of the weights, layer by layer), and at the
    position where each served token was chosen the gap by which that
    token's reference logit lies below the reference's largest. The
    number is the mean gap over the served tokens; the widest
    (``logit_gap``) is reported beside it. The first served token comes
    from the prefill, the others from the decode steps, so it covers both.
    The widest gap is not compared: it is the tail of the rounding error
    at the one or two positions where the reference's two best tokens
    nearly tie, and it grows with coarser arithmetic only as that error's
    spread does, under three times from bfloat16 to float8, where the mean
    (how often and how far the served token falls below the best) grows
    four to five times.
  * ``pool_mismatches``: the program's cold or warm verdict of every
    request served (warm-ups included) and its loads and unloads, step by
    step, against :func:`portbench.reference.pool.replay` of the same
    arrivals; the number of verdicts that differ plus the actions that one
    side has and the other has not. Its limit is 0.

The controls (only when asked for, never in a benchmark run): the same
prompts and tokens through the reference computed in float8 e4m3, ``w8``
with its matrices rounded (a scale per output channel; the router, norm
scales and biases kept), ``w8a8`` with every product's input rounded too
(a scale per token); at each position the gap of the token that the
control puts first. They are what the logit limit has to reject: in a
run with the controls, ``w8a8``'s mean gap (:data:`CONTROL`) takes the
program's place in ``logit_gap_mean``, so that the run's ``correct``
judges the control, and the program's own readings stay in the readings.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List

import numpy as np
import torch

from . import traffic as traffic_mod, weights
from .reference import pool as pool_ref

__all__ = ["BIG", "CONTROLS", "CONTROL", "sample", "fp8_weights", "fp8_activations",
           "logit_gaps", "pool_mismatches", "run_checks"]

#: What an infinite or undefined gap is reported as (JSON has no inf).
BIG = 1e30


def sample(window: List[tuple], seed: int, tokens: int) -> List[tuple]:
    """(request, record) pairs of completed window requests: the longest
    (prompt + new), then others in an order drawn from the seed, until
    their served tokens reach ``tokens``."""
    done = [(q, r) for q, r in window if not r["error"]]
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (done[i][0].prompt + done[i][0].new, -i))
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, 0x5A3])))
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    out, n = [], 0
    for i in [longest] + rest:
        out.append(done[i])
        n += done[i][0].new
        if n >= tokens:
            break
    return out


def _fp8(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, one scale along ``axis``."""
    scale = x.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_weights(name: str, w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with a scale per output channel (the
    last axis of a ``[d_in, d_out]`` matrix or ``[E, d_in, d_out]`` stack,
    the row of the embedding); vectors and the router as they are."""
    if w.dim() < 2 or name.endswith("router.w"):
        return w
    return _fp8(w, -1 if name == "embed.table" else -2)


def fp8_activations(x: torch.Tensor) -> torch.Tensor:
    """A product's input rounded to float8 e4m3, a scale per token."""
    return _fp8(x, -1)


#: The precision controls: (weights, activations) hooks of the reference.
CONTROLS = {"w8": (fp8_weights, None), "w8a8": (fp8_weights, fp8_activations)}
#: The control that a run with the controls judges in the program's place.
CONTROL = "w8a8"


def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _gaps(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per position, how far the picked token's reference logit lies below
    the reference's largest."""
    return ref.max(-1).values - ref.gather(-1, picked[:, None])[:, 0]


def logit_gaps(cell, seed: int, picked: List[tuple], device,
               control: bool = False) -> Dict[str, float]:
    """``logit_gap`` (the widest) and ``logit_gap_mean`` over the served
    tokens of the ``picked`` (request, record) pairs; with ``control`` the
    same two readings of each of :data:`CONTROLS` (``<control>_max``,
    ``<control>_mean``), the token each puts first judged at every
    position."""
    _fp32_matmuls()
    cfg = cell.config
    m = dict(cfg["model"], **cfg.get("as_run", {}))
    groups = dict(cell.reference.param_layout(cfg["model"]))
    gaps = collections.defaultdict(list)
    by_app = collections.defaultdict(list)
    for q, r in picked:
        by_app[q.app].append((q, r))
    for e, reqs in sorted(by_app.items()):
        seqs, positions, served = [], [], []
        for q, r in reqs:
            out = torch.tensor(r["out"], dtype=torch.int64, device=device)
            if out.numel() != q.new or bool(((out < 0) |
                                             (out >= m["vocab"])).any()):
                return {"logit_gap": BIG, "logit_gap_mean": BIG}
            prompt = traffic_mod.prompt_tokens(q, m["vocab"], device)[0]
            seqs.append((torch.cat([prompt, out[:-1]]), q.prompt))
            positions.append(torch.arange(q.prompt - 1,
                                          q.prompt + q.new - 1,
                                          device=device))
            served.append(out)

        def fetch(group, e=e):
            return {n: t.float() for n, t in weights.draw_group(
                groups[group], cfg["init"], m["n_layers"], seed, e, group,
                device).items()}

        with torch.inference_mode():
            ref = cell.reference.forward_logits(m, fetch, seqs, positions)
            gaps["served"] += [_gaps(lg, tok) for lg, tok in zip(ref, served)]
            for name, (tw, ta) in (CONTROLS.items() if control else ()):
                low = cell.reference.forward_logits(
                    m, fetch, seqs, positions, transform=tw, act=ta)
                gaps[name] += [_gaps(lg, lw.argmax(-1))
                               for lg, lw in zip(ref, low)]
            del ref
    clean = lambda v: v if math.isfinite(v) else BIG
    out = {}
    for name, parts in gaps.items():
        g = torch.cat(parts)
        key = "logit_gap" if name == "served" else name
        out[key if name == "served" else f"{key}_max"] = clean(float(g.max()))
        out[f"{key}_mean"] = clean(float(g.mean()))
    return out


def pool_mismatches(cell, served: List[tuple], actions: List[tuple],
                    image_bytes: float, budget: float) -> int:
    """Verdicts and actions of the program that the replay does not give,
    plus those of the replay the program does not."""
    mix = cell.traffic
    where = {q.index: i for i, (q, _) in enumerate(served)}
    colds, want = pool_ref.replay([(q.app, q.arrival_s) for q, _ in served],
                                  mix["endpoints"], mix["policy"],
                                  [image_bytes] * mix["endpoints"], budget)
    got = [(where[i], step, e, verb) for i, step, e, verb in actions]
    wrong = sum(bool(r["cold"]) != c for (_, r), c in zip(served, colds))
    a, b = collections.Counter(got), collections.Counter(want)
    return wrong + sum(((a - b) + (b - a)).values())


def run_checks(cell, seed: int, served: List[tuple], actions: List[tuple],
               image_bytes: float, budget: float, device,
               control: bool = False):
    """(checks, readings): each compared number with its limit, and every
    reading taken (the controls' too, with ``control``, where
    :data:`CONTROL`'s mean gap is the one compared)."""
    c = cell.config["correct"]
    window = [(q, r) for q, r in served if q.index >= 0]
    picked = sample(window, seed, c["sample_tokens"])
    readings = logit_gaps(cell, seed, picked, device, control) if picked \
        else {"logit_gap": BIG, "logit_gap_mean": BIG}
    readings["sampled_tokens"] = sum(q.new for q, _ in picked)
    judged = f"{CONTROL}_mean" if control else "logit_gap_mean"
    checks = {"logit_gap_mean": {"value": readings.get(judged, BIG),
                                 "limit": c["logit_gap_mean_limit"]},
              "pool_mismatches": {"value": pool_mismatches(
                  cell, served, actions, image_bytes, budget), "limit": 0}}
    return checks, readings
