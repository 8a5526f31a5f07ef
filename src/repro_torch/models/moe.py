"""Mixture-of-Experts transformer (the OLMoE / Qwen3-MoE family). The port
of ``repro/models/moe.py``.

Each block: rmsnorm, GQA self-attention with RoPE, residual; rmsnorm, a
top-k routed MoE FFN, residual. Dispatch follows the GShard capacity
algorithm, exactly as the reference routes: tokens in groups of
``moe_group_size``, ``C = max(int(cf * k * T / E), 1)`` slots per expert
and group, the k choices admitted in priority order, overflow dropped.

  * ``moe_impl="einsum"`` — the dense dispatch/combine products over
    ``[G, T, E, C]`` one-hots (the reference's baseline);
  * ``moe_impl="gather"`` — the same routing by index: each kept (token,
    choice) is added into its own slot (``index_add_``; a kept slot gets at
    most one token and every dropped one goes to the sentinel row
    ``E * C``, so no two adds meet and the result is the same on every
    run), and read back by a gather.

The router computes in f32 on an f32 weight (``layers.FP32_AT_USE`` keeps
``router.w`` fp32 when an engine casts the rest). Expert weights are
stacked ``[E, d_model, d_expert]`` / ``[E, d_expert, d_model]``; the
products are plain ``torch.einsum``s, as the reference leaves them to XLA
(it has no kernel here), except on a one-token step (decode) with the
kernels on: there, where the ``B * top_k`` choices name fewer than ``E``
experts, only the chosen experts run, in the gathered-expert kernel
(``kernels.expert_gather``; weights ``topv`` times ``keep``, the slot loop
skipped where capacity ``C >= T`` cannot drop a choice). Attention, the KV
cache and the kernel branches are the dense family's
(``layers.attention_apply``). Training (``loss_fn``) re-computes each block
in the backward under ``cfg.remat``.

The dropless layer (:class:`DroplessMoE`, :func:`dropless_apply`; the
Nemotron-H family's, ``models.nemotron_h``) has no capacity: every choice is
computed. Its router is the sigmoid one (``s = sigmoid(x W_r)`` in f32, the
top k of ``s + e_bias`` chosen, the bias only choosing, and weights ``s /
(sum of the chosen s + 1e-20) * cfg.routed_scaling``); its experts are relu²
(``wo(relu(wi x)^2)``, no gate), beside an always-on shared expert of
``cfg.d_shared_expert``. It holds the first ``cfg.n_held`` routed experts (a
device's share under expert parallelism): the router scores all
``n_experts`` and picks among them, and only the held experts' terms are
added. Over a prompt it sorts the held choices by expert and runs each
expert on its own tokens, reading the per-expert counts on the host once a
layer (``HELD_CHOICES`` adds up the choices computed). Over one token a
sequence (decode) it runs, with the kernels on and ``B * top_k`` below
``n_experts`` (as the GShard layer), only the chosen held experts in the
gathered-expert kernel (a choice of an expert not held weighted 0, and
skipped); otherwise every held expert with static shapes, the unchosen
weighted by zero. Neither
reads the device from the host, so a CUDA graph captures the step.
"""
from __future__ import annotations

import math
import types
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed import compat, ctx
from ..kernels import expert_gather as eg
from . import layers as L
from .transformer import _init_params, _logits

__all__ = ["MoEFFN", "MoEBlock", "MoEParams", "init", "depth_scale_",
           "moe_apply", "moe_block_apply", "forward", "loss_fn", "prefill",
           "decode_step", "SharedExpert", "DroplessMoE", "route_topk",
           "dropless_apply", "gathers", "counters", "HELD_CHOICES"]

#: Routed choices the dropless layer's prompt path computed on held experts
#: in this process (a host count: the path reads its per-expert counts on
#: the host anyway). The decode path's choices are not counted (it runs
#: under a CUDA graph, where no host code runs).
HELD_CHOICES = 0

# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class MoEFFN(nn.Module):
    """The router ``Linear(D, E)`` and the stacked SwiGLU experts: ``wi``,
    ``wg`` ``[E, D, F]`` and ``wo`` ``[E, F, D]``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, D, Fe = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.router = L.Linear(D, E)
        self.wi = nn.Parameter(torch.empty(E, D, Fe))
        self.wg = nn.Parameter(torch.empty(E, D, Fe))
        self.wo = nn.Parameter(torch.empty(E, Fe, D))

    def init_(self, gen: torch.Generator) -> None:
        # the reference's scales: 1/sqrt(D) into the experts and the
        # router, 1/sqrt(F) out of them (not the stacked first dimension E)
        D, Fe = self.wi.shape[1], self.wi.shape[2]
        s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fe)
        L.normal_(self.router.w, gen, scale=s_in)
        L.normal_(self.wi, gen, scale=s_in)
        L.normal_(self.wg, gen, scale=s_in)
        L.normal_(self.wo, gen, scale=s_out)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model)
        self.attn = L.Attention(cfg)
        self.ln2 = L.RMSNorm(cfg.d_model)
        self.moe = MoEFFN(cfg)

    def init_(self, gen: torch.Generator) -> None:
        self.attn.init_(gen)
        self.moe.init_(gen)


class MoEParams(nn.Module):
    """``embed``, ``layers`` (one :class:`MoEBlock` per layer), ``ln_f``
    and ``head`` (the family's unembedding is never tied)."""

    #: The module lists whose blocks the reference stacks on a leading
    #: axis (one leaf ``[n, ...]`` per parameter name).
    STACKED = ("layers",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab, cfg.d_model)
        self.layers = nn.ModuleList(MoEBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.RMSNorm(cfg.d_model)
        self.head = L.Linear(cfg.d_model, cfg.vocab)


def init(cfg: ModelConfig, seed: int = 0, device=None) -> MoEParams:
    """Random fp32 parameters from ``seed`` on ``device`` with the
    reference's distributions (see :class:`MoEFFN` for the experts' and
    the router's scales; unit norm scales, the embedding at 0.02)."""
    return _init_params(MoEParams, cfg, seed, device)


def depth_scale_(cfg: ModelConfig, params: MoEParams) -> MoEParams:
    """The ``"depth_scaled"`` draw, in place on :func:`init`'s: each
    residual branch's output projection (``attn.wo`` and the experts'
    ``wo``) times 1/sqrt(2 n_layers), GPT-2's depth scaling, and the
    embedding at unit scale (the reference draws it at 0.02).

    At :func:`init`'s draw the hidden states of a long prompt converge
    onto each other within a few layers (random attention averages its
    prefix, and the 0.02 embedding is soon outweighed), so every token
    routes to the same few experts, capacity drops most choices, and a
    last-bit difference anywhere reorders near-equal gates. Here token
    identity carries through the depth and the router's load stays about
    balanced, as a trained router keeps it."""
    f = 1.0 / math.sqrt(2 * cfg.n_layers)
    with torch.no_grad():
        params.embed.table.mul_(1.0 / 0.02)
        for lp in params.layers:
            lp.attn.wo.w.mul_(f)
            lp.moe.wo.mul_(f)
    return params


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------


def _capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert and group of ``T`` tokens."""
    return max(int(cfg.moe_capacity_factor * cfg.top_k * T / cfg.n_experts),
               1)


def _topk(cfg: ModelConfig, p: MoEFFN, xg: torch.Tensor):
    """The router over token groups ``xg`` [G, T, D]: (gates [G, T, E] f32,
    topi [G, T, k] int64, topv [G, T, k] f32 renormalised).

    The top k are the first k columns of a stable descending sort, so that
    among equal gates the lower expert comes first, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order among ties)."""
    k = cfg.top_k
    logits = xg.float() @ p.router.w.float()
    gates = torch.softmax(logits, dim=-1)                        # [G,T,E]
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    return gates, topi, topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)


def _route(cfg: ModelConfig, p: MoEFFN, xg: torch.Tensor, mean=None):
    """Router and slot assignment for token groups ``xg`` [G, T, D]:
    (topi [G, T, k] int64, topv [G, T, k] f32 renormalised, positions
    [G, T, k] int64, keep [G, T, k] bool, C, the Switch aux loss); the
    top k as :func:`_topk` chooses them.

    ``mean`` (the per-shard routing under a mesh) turns the aux loss's two
    means over this shard's groups into means over every group."""
    G, T, _ = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, T)
    gates, topi, topv = _topk(cfg, p, xg)

    # slot positions: the k choices in priority order, each expert counting
    # the tokens it has admitted so far in the group
    counts = torch.zeros((G, E), dtype=torch.int64, device=xg.device)
    pos_list, keep_list = [], []
    for j in range(k):
        e_j = topi[..., j]                                       # [G,T]
        onehot = F.one_hot(e_j, E)                               # [G,T,E]
        pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None, :]
        pos_j = torch.gather(pos, -1, e_j[..., None])[..., 0]
        keep_list.append(pos_j < C)
        pos_list.append(pos_j)
        counts = counts + onehot.sum(dim=1)
    positions = torch.stack(pos_list, -1)
    keep = torch.stack(keep_list, -1)

    # load-balancing auxiliary loss (Switch): E * mean(frac tokens * prob)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))
    if mean is not None:
        me, ce = mean(me), mean(ce)
    aux = E * torch.sum(me * ce)
    return topi, topv, positions, keep, C, aux


def _route_sharded(cfg: ModelConfig, p: MoEFFN, xg: torch.Tensor):
    """:func:`_route`; under a mesh per shard of groups (over data: DTensor
    has no rule for the backward of its sort and one-hot counts), with the
    aux loss's two means taken over every group (summed over the data
    axes)."""
    if not isinstance(xg, DTensor):
        return _route(cfg, p, xg)
    mesh = xg.device_mesh
    gs = ctx.spec(xg.shape, "data", None, None)
    split = [a for a in mesh.mesh_dim_names
             if any(a == ax or (isinstance(ax, tuple) and a in ax)
                    for ax in gs if ax is not None)]

    def over_groups(t):
        for a in split:
            t = compat.psum_replicated(t, mesh, a) / mesh.size(
                mesh.mesh_dim_names.index(a))
        return t

    def body(xg, w):
        local = types.SimpleNamespace(router=types.SimpleNamespace(w=w))
        topi, topv, positions, keep, _, aux = _route(cfg, local, xg,
                                                     over_groups)
        return topi, topv, positions, keep, aux

    topi, topv, positions, keep, aux = compat.shard_map(
        body, mesh, (gs, ctx.spec(p.router.w.shape, None, None)),
        (gs, gs, gs, gs, ctx.spec(())))(xg, p.router.w)
    return topi, topv, positions, keep, _capacity(cfg, xg.shape[1]), aux


def _experts(p: MoEFFN, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their slots: xe [G, E, C, D] -> [G, E, C, D]."""
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, p.wg.to(dt))
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, p.wi.to(dt))
    return torch.einsum("gecf,efd->gecd", h, p.wo.to(dt))


def _moe_einsum(cfg, p, xg, topi, topv, positions, keep, C):
    """Dense GShard dispatch and combine over [G, T, E, C] one-hots."""
    E = cfg.n_experts
    dt = xg.dtype
    e_oh = F.one_hot(topi, E).to(dt)                             # [G,T,k,E]
    # a dropped choice's position is >= C: its slot one-hot is all zero,
    # as jax.nn.one_hot makes it
    c_oh = F.one_hot(torch.where(keep, positions, C), C + 1)[..., :C].to(dt)
    kd = e_oh * keep[..., None].to(dt)
    dispatch = torch.einsum("gtke,gtkc->gtec", kd, c_oh)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", kd, c_oh, topv.to(dt))
    xe = torch.einsum("gtd,gtec->gecd", xg, dispatch)
    return torch.einsum("gecd,gtec->gtd", _experts(p, xe), combine)


def _moe_gather(cfg, p, xg, topi, topv, positions, keep, C):
    """Index-based dispatch with the same routing: each kept (token,
    choice) added into slot ``e * C + pos``, every dropped one into the
    sentinel row ``E * C`` (times 0), then read back by slot."""
    G, T, D = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = xg.dtype
    rows = E * C + 1
    slot = torch.where(keep, topi * C + positions, E * C)        # [G,T,k]
    flat = (slot + rows * torch.arange(G, device=xg.device)[:, None, None])
    src = xg[:, :, None, :] * keep[..., None].to(dt)             # [G,T,k,D]
    xe = torch.zeros((G * rows, D), dtype=dt, device=xg.device)
    xe.index_add_(0, flat.reshape(-1), src.reshape(-1, D))
    xe = xe.view(G, rows, D)[:, :E * C].reshape(G, E, C, D)
    ye = _experts(p, xe).reshape(G, E * C, D)
    ye = torch.cat([ye, ye.new_zeros((G, 1, D))], dim=1)
    out = torch.gather(ye, 1, slot.reshape(G, T * k, 1).expand(G, T * k, D))
    out = out.reshape(G, T, k, D) * topv[..., None].to(dt)
    return out.sum(dim=2)


def gathers(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """Whether an MoE layer over ``x`` [B, S, D] runs only its chosen
    experts (:func:`kernels.expert_gather.expert_gather`): with the
    kernels on, one token a sequence (decode), and fewer choices (``B *
    top_k``) than the router's ``n_experts``; never under a mesh.

    Below that count the chosen pairs read fewer experts' weights than
    the dense products (every expert the layer holds) do. For the
    dropless layer, holding ``n_held`` of the ``n_experts``, the pairs
    that read a held expert's weights are about ``B * top_k * n_held /
    n_experts`` (a choice of an expert not held reads none), below
    ``n_held`` under the same count. The crossover is reasoned from
    bytes, not measured."""
    B, S, _ = x.shape
    return cfg.use_kernels and S == 1 and B * cfg.top_k < cfg.n_experts \
        and not isinstance(x, DTensor)


def _moe_gathered(cfg, p, xg, need_aux: bool):
    """The GShard layer over groups ``xg`` [G, T, D] by its chosen experts
    alone -> (y [G * T, D], aux or None). Where capacity cannot bind (``C
    >= T``: no expert gets more of a group's tokens than it has slots) and
    the aux loss is not needed, only the router's top k run: every choice
    is kept. Else :func:`_route` gives ``keep`` (and the aux loss)."""
    G, T, D = xg.shape
    if need_aux or _capacity(cfg, T) < T:
        topi, topv, _, keep, _, aux = _route(cfg, p, xg)
        topv = topv * keep
    else:
        _, topi, topv = _topk(cfg, p, xg)
        aux = None
    k, dt = cfg.top_k, xg.dtype
    y = eg.expert_gather(xg.reshape(G * T, D), topi.reshape(G * T, k),
                         topv.reshape(G * T, k), p.wi.to(dt), p.wg.to(dt),
                         p.wo.to(dt))
    return y, aux


def moe_apply(cfg: ModelConfig, p: MoEFFN, x: torch.Tensor,
              need_aux: bool = True):
    """x [B, S, D] -> (y [B, S, D], aux loss), dispatched as
    ``cfg.moe_impl`` ("einsum" or "gather") says, or by the chosen experts
    alone where :func:`gathers` holds; there, without ``need_aux``, the aux
    loss may be None."""
    impl = cfg.moe_impl
    if impl not in ("einsum", "gather"):
        raise ValueError(f"moe_apply: unknown impl {impl!r}")
    B, S, D = x.shape
    T = min(cfg.moe_group_size, B * S)
    G = (B * S) // T
    # groups of whole sequences: under a mesh the batch over data only
    x = ctx.hint(x, "data", None, None)
    xg = x.reshape(G, T, D)
    if gathers(cfg, x):
        y, aux = _moe_gathered(cfg, p, xg, need_aux)
        return y.reshape(B, S, D), aux
    topi, topv, positions, keep, C, aux = _route_sharded(cfg, p, xg)
    fn = _moe_einsum if impl == "einsum" else _moe_gather
    y = _dispatch(fn, cfg, p, xg, topi, topv, positions, keep, C)
    return ctx.hint(y.reshape(B, S, D), "data", None, None), aux


def _dispatch(fn, cfg, p, xg, topi, topv, positions, keep, C):
    """``fn`` (the einsum or gather dispatch) as it is without a mesh.
    Under one it runs per shard (``compat.shard_map``; DTensor has no rule
    for the dispatch's products and scatters): the groups over data, the
    experts over model (EP) when they divide it. Each model rank dispatches
    its groups' choices of its own experts (the others are dropped there)
    and the partial outputs are summed over model: the layouts of the
    reference's hints on dispatch, combine and the experts' inputs
    (``moe.py:92-96``, ``115``), which here fall inside the shard."""
    if not isinstance(xg, DTensor):
        return fn(cfg, p, xg, topi, topv, positions, keep, C)
    mesh = xg.device_mesh
    gs = ctx.spec(topi.shape, "data", None, None)
    es = ctx.spec(p.wi.shape, "model", None, None)
    ep = es[0] is not None

    def body(xg, topi, topv, positions, keep, wi, wg, wo):
        e_loc = wi.shape[0]
        e0 = compat.axis_index(mesh, "model") * e_loc if ep else 0
        mine = (topi >= e0) & (topi < e0 + e_loc)
        local = types.SimpleNamespace(wi=wi, wg=wg, wo=wo)
        y = fn(cfg.with_(n_experts=e_loc), local, xg,
               torch.where(mine, topi - e0, 0), topv, positions,
               keep & mine, C)
        return compat.psum_replicated(y, mesh, "model") if ep else y

    xs = ctx.spec(xg.shape, "data", None, None)
    return compat.shard_map(body, mesh, (xs, gs, gs, gs, gs, es, es, es),
                            xs)(xg, topi, topv, positions, keep, p.wi, p.wg,
                                p.wo)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def moe_block_apply(cfg: ModelConfig, p: MoEBlock, x, positions, cache=None):
    """One block with its residuals -> (x, aux); ``cache`` (one layer's
    ``k``, ``v`` and ``pos``) is written in place. With a cache (prefill
    and decode, which discard it) the aux loss may be None."""
    x = x + L.attention_apply(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps),
                              positions, cache=cache)
    h, aux = moe_apply(cfg, p.moe, L.rmsnorm(p.ln2, x, cfg.norm_eps),
                       need_aux=cache is None)
    return ctx.hint(x + h, "data", "model", None), aux


def forward(cfg: ModelConfig, params: MoEParams, tokens):
    """Full-sequence logits [B, S, vocab] and the mean aux loss over the
    layers, as the reference returns them."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params.layers:
        x, a = L.remat(cfg, lambda x, lp=lp: moe_block_apply(cfg, lp, x,
                                                             positions), x)
        aux = aux + a
    return _logits(cfg, params, x), aux / cfg.n_layers


def loss_fn(cfg: ModelConfig, params: MoEParams, batch: Dict):
    """The cross-entropy of ``batch`` plus ``router_aux_weight`` times the
    mean load-balancing aux loss, as the reference adds them."""
    logits, aux = forward(cfg, params, batch["tokens"])
    return (L.softmax_xent(logits, batch["labels"], batch.get("mask"))
            + cfg.router_aux_weight * aux)


def prefill(cfg: ModelConfig, params: MoEParams, tokens, max_len: int = 0):
    """Prompt pass: last-token logits [B, 1, vocab] and a KV cache of
    capacity ``max_len`` (0: the prompt's length), ``pos`` = S as a 0-d
    device tensor."""
    x = L.embed(params.embed, tokens, L.compute_dtype(cfg))
    B, S, _ = x.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"prefill: max_len {max_len} < prompt length {S}")
    cache = L.make_cache(cfg, B, max_len, cfg.n_layers, x.dtype, x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x, _ = moe_block_apply(cfg, lp, x, positions,
                               cache={"k": ck, "v": cv, "pos": 0})
    cache["pos"] = L.device_pos(S, x.device)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: MoEParams, token, cache: Dict):
    """One token per sequence against the cache -> (logits [B, vocab], the
    cache with ``pos`` advanced; its tensors are written in place)."""
    x = L.embed(params.embed, token[:, None], L.compute_dtype(cfg))
    B = x.shape[0]
    pos = cache["pos"]
    positions = L.step_positions(pos, B, x.device)
    for lp, ck, cv in zip(params.layers, cache["k"], cache["v"]):
        x, _ = moe_block_apply(cfg, lp, x, positions,
                               cache={"k": ck, "v": cv, "pos": pos})
    logits = _logits(cfg, params, x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def counters(cfg: ModelConfig) -> Dict[str, int]:
    """The counters a request of this family reports, as they stand:
    ``expert_gather_launches``, the gathered-expert kernel's calls (one a
    MoE layer a one-token step where :func:`gathers` holds)."""
    return {"expert_gather_launches": eg.LAUNCHES}


# ---------------------------------------------------------------------------
# The dropless layer (sigmoid router, held share, shared expert)
# ---------------------------------------------------------------------------


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


class SharedExpert(nn.Module):
    """The always-on expert: ``wo(relu(wi x)^2)``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.wi = L.Linear(cfg.d_model, cfg.d_shared_expert)
        self.wo = L.Linear(cfg.d_shared_expert, cfg.d_model)

    def init_(self, gen: torch.Generator) -> None:
        self.wi.init_(gen)
        self.wo.init_(gen)


class DroplessMoE(nn.Module):
    """The router ``Linear(D, E)`` over all ``n_experts``, its correction
    bias ``e_bias`` [E], the held experts stacked ``wi`` ``[n_held, D, F]``
    and ``wo`` ``[n_held, F, D]``, and the shared expert where
    ``d_shared_expert``. Its router is the sigmoid one and its experts
    relu²: the layer has no other kind."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        E, H, D, Fe = cfg.n_experts, cfg.n_held, cfg.d_model, cfg.d_expert
        self.router = L.Linear(D, E)
        self.e_bias = nn.Parameter(torch.zeros(E))
        self.wi = nn.Parameter(torch.empty(H, D, Fe))
        self.wo = nn.Parameter(torch.empty(H, Fe, D))
        if cfg.d_shared_expert:
            self.shared = SharedExpert(cfg)

    def init_(self, gen: torch.Generator) -> None:
        D, Fe = self.wi.shape[1], self.wi.shape[2]
        L.normal_(self.router.w, gen, scale=1.0 / math.sqrt(D))
        L.normal_(self.wi, gen, scale=1.0 / math.sqrt(D))
        L.normal_(self.wo, gen, scale=1.0 / math.sqrt(Fe))
        if hasattr(self, "shared"):
            self.shared.init_(gen)


def route_topk(cfg: ModelConfig, p: DroplessMoE, x: torch.Tensor):
    """The sigmoid router of tokens ``x`` [T, D]: (experts [T, k] int64,
    weights [T, k] f32), the k largest of ``s + e_bias`` chosen by a stable
    descending sort (ties to the lower expert)."""
    s = torch.sigmoid(x.float() @ p.router.w.float())
    _, idx = torch.sort(s + p.e_bias.float(), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :cfg.top_k]
    w = torch.gather(s, -1, idx)
    return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling


def _held_expert(p, x, e: int, out=None):
    """Held expert ``e`` on tokens ``x`` [N, D] (into ``out`` when
    given)."""
    dt = x.dtype
    return torch.matmul(_relu2(x @ p.wi[e].to(dt)), p.wo[e].to(dt), out=out)


def dropless_apply(cfg: ModelConfig, p: DroplessMoE, x: torch.Tensor):
    """x [B, S, D] -> y [B, S, D]: the held experts' weighted terms of every
    token's top-k choices (none dropped), plus the shared expert. S > 1
    (a prompt): the held choices sorted by expert, each held expert on its
    rows; S == 1 (decode): where :func:`gathers` holds, the chosen held
    experts alone, else every held expert on every token; static shapes
    either way."""
    global HELD_CHOICES
    B, S, D = x.shape
    T, k, H = B * S, cfg.top_k, cfg.n_held
    xf = x.reshape(T, D)
    idx, w = route_topk(cfg, p, xf)
    held = idx < H
    dt = x.dtype
    if gathers(cfg, x):
        y = eg.expert_gather(xf, idx, torch.where(held, w, 0.0),
                             p.wi.to(dt), None, p.wo.to(dt))
    elif S == 1:
        # combine weights [T, H]: a chosen held expert's weight, else 0
        c = (F.one_hot(torch.where(held, idx, H), H + 1)[..., :H]
             * w[..., None]).sum(1)
        h = _relu2(torch.matmul(xf, p.wi.to(dt)))              # [H, T, F]
        ye = torch.matmul(h, p.wo.to(dt))                      # [H, T, D]
        y = (ye * c.t().to(dt)[..., None]).sum(0)
    else:
        e_all = torch.where(held, idx, H).reshape(-1)
        order = torch.argsort(e_all, stable=True)     # held choices first
        counts = torch.bincount(e_all, minlength=H + 1)[:H].tolist()
        n = sum(counts)
        HELD_CHOICES += n
        sl = order[:n]                        # their (token, choice) slots
        xs = xf[sl // k]
        ys = torch.empty_like(xs)
        start = 0
        for e, c in enumerate(counts):
            if c:
                _held_expert(p, xs[start:start + c], e,
                             out=ys[start:start + c])
                start += c
        slots = torch.zeros((T * k, D), dtype=dt, device=x.device)
        slots[sl] = ys * w.reshape(-1)[sl, None].to(dt)
        y = slots.view(T, k, D).sum(1)
    if hasattr(p, "shared"):
        y = y + L.linear(p.shared.wo, _relu2(L.linear(p.shared.wi, xf)))
    return y.reshape(B, S, D)
