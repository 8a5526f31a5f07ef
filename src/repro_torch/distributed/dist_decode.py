"""Distributed flash-decode: attention of one new token over a KV cache
sharded along the sequence over "model" (the port of
``repro/distributed/dist_decode.py``, plain PyTorch as the reference's is
plain JAX: no kernel).

  * each model rank owns a contiguous ``Skv / m`` block of every layer's
    cache ``[B, Skv, Hkv, hd]`` (a DTensor, ``Shard(1)`` over "model");
  * the new token's K/V is written ONLY by the rank that owns position
    ``pos`` (a host int here, so the write is a branch, in place on that
    rank's shard);
  * each rank computes a partial flash-attention over its block in f32
    (running max m, denominator l, accumulator acc);
  * the partials merge with one all-reduce MAX and two all-reduce SUMs of
    ``[B, Hkv, group(, hd)]``-sized tensors (the log-sum-exp merge),
    instead of moving the cache.

Enable with ``repro_torch.distributed.dist_decode.ENABLED = True``;
``sharding.cache_specs_tree`` then emits sequence-sharded cache specs and
``layers.attention_apply`` takes :func:`decode_attention` where
:func:`applicable` holds.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import compat, ctx

__all__ = ["ENABLED", "applicable", "decode_attention"]

# Flipped by the launcher / dry-run (--optimized); read by the sharding
# rules too.
ENABLED = False


def applicable(Skv: int, Sq: int) -> bool:
    mesh = ctx.active_mesh()
    if not ENABLED or mesh is None or Sq != 1:
        return False
    m = ctx.axis_size("model")
    return m > 1 and Skv % m == 0


def decode_attention(q, k_new, v_new, cache_k, cache_v, pos: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,1,Hq,hd]; k_new/v_new [B,1,Hkv,hd] (rope'd); cache_k/v
    [B,Skv,Hkv,hd] DTensors sequence-sharded over "model" (written in
    place); ``pos`` the host int position of the new token.

    Returns (out [B,1,Hq,hd], cache_k, cache_v)."""
    mesh = ctx.active_mesh()
    B, Skv, Hkv, hd = cache_k.shape
    Hq = q.shape[2]
    s_local = Skv // ctx.axis_size("model")
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)

    def body(q, k_new, v_new, ck, cv):
        idx = compat.axis_index(mesh, "model")
        b = q.shape[0]
        # --- local cache write (only the owning shard writes) -------------
        off = pos - idx * s_local
        if 0 <= off < s_local:
            ck[:, off] = k_new[:, 0].to(ck.dtype)
            cv[:, off] = v_new[:, 0].to(cv.dtype)
        # --- local partial flash attention --------------------------------
        qf = q[:, 0].reshape(b, Hkv, group, hd).float() * scale
        s = torch.einsum("bhgd,bshd->bhgs", qf, ck.float())   # [b,Hkv,g,s]
        jpos = idx * s_local + torch.arange(s_local, device=q.device)
        valid = jpos <= pos
        s = torch.where(valid, s, -1e30)
        m_loc = s.amax(dim=-1)                                # [b,Hkv,g]
        p = torch.where(valid, torch.exp(s - m_loc[..., None]), 0.0)
        l_loc = p.sum(-1)
        acc = torch.einsum("bhgs,bshd->bhgd", p, cv.float())
        # --- log-sum-exp merge across sequence shards ----------------------
        m_glob = compat.pmax(m_loc.clone(), mesh, "model")
        alpha = torch.exp(m_loc - m_glob)
        l_glob = compat.psum(l_loc * alpha, mesh, "model")
        acc_glob = compat.psum(acc * alpha[..., None], mesh, "model")
        out = acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]
        return out.reshape(b, 1, Hq, hd).to(q.dtype)

    rows = ctx.spec(q.shape, "data", None, None, None)
    cache = ctx.spec(cache_k.shape, "data", "model", None, None)
    out = compat.shard_map(body, mesh, (rows, rows, rows, cache, cache),
                           rows)(q, k_new, v_new, cache_k, cache_v)
    return out, cache_k, cache_v
