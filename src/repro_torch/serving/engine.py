"""Serve engine: runs real model steps for loaded endpoints.

The port of ``repro/serving/engine.py``: a per-app host weight store (fp32,
made from the endpoint's seed at first load), the device copies of the
loaded apps, and greedy batched decode. PyTorch runs eagerly, so there is
no ``jit`` and no executable cache: a cold start here is the weights'
trip to the device (plus, at an app's first load, their initialisation).

Every family serves: dense (Qwen2; a VLM backbone serves text only, as in
the reference), MoE (OLMoE), encoder-decoder (SeamlessM4T, whose encoder
gets the reference's frontend stub: zero frames), hybrid (RecurrentGemma)
and SSM (Mamba-2). The device copy is cast once at load to the activation
dtype, except the parameters the model keeps in fp32 at use
(``layers.FP32_AT_USE``: the ``rmsnorm`` scales, the RG-LRU ``lam``,
Mamba-2's ``A_log`` and ``dt_bias``, the MoE router's ``router.w``).
Casting every other parameter at use, as the reference does, gives the same numbers; casting once avoids
re-reading the fp32 weights (11.6 GB for RecurrentGemma-2B, 10.8 GB for
Mamba-2-2.7B, 30.5 GB for Qwen2-7B) on every decode step, and matches the registry's cost
model, which counts ``2 * n_params`` bytes per image.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..kernels import ssd_scan
from ..models import Model, build
from ..models.layers import compute_dtype, fp32_at_use
from .registry import Registry

__all__ = ["ServeEngine"]


#: Most bytes of one pinned host chunk the engine packs an image's
#: parameters into. PyTorch's pinned allocator rounds every allocation up
#: to a power of two and keeps freed blocks cached by size: one pinned
#: tensor per parameter would pin 58 GB for Qwen2-7B's 30.5 GB fp32 image,
#: one buffer per image would round 11.6 GB up to 17.2 GB. Chunks of this
#: size, with the last one only as large as what is left of the image,
#: waste at most the rounding of that last chunk, and a later model reuses
#: the full chunks an earlier one freed. 4 GiB holds the largest parameter
#: served (RecurrentGemma-2B's 2.6 GB embedding table).
HOST_CHUNK_BYTES = 1 << 32

_HOST_ALIGN = 64                        # bytes; keeps every view aligned


def _host_layout(sizes, chunk_bytes: int = HOST_CHUNK_BYTES):
    """Where parameters of ``sizes`` bytes go in host memory: the chunks'
    sizes and, per parameter, its (chunk, byte offset). First fit, each
    view aligned to ``_HOST_ALIGN``; a new chunk holds ``chunk_bytes`` or,
    where less is still to place, just that (so a small image is one
    allocation of its own size); a larger parameter gets a chunk of its
    own."""
    aligned = [-(-n // _HOST_ALIGN) * _HOST_ALIGN for n in sizes]
    left = sum(aligned)
    chunks, used, where = [], [], []
    for n, a in zip(sizes, aligned):
        c = next((i for i, (cap, u) in enumerate(zip(chunks, used))
                  if u + n <= cap), None)
        if c is None:
            c = len(chunks)
            chunks.append(max(n, min(chunk_bytes, left)))
            used.append(0)
        where.append((c, used[c]))
        used[c] += a
        left -= a
    return chunks, where


def _to_host(params: nn.Module, pin: bool) -> nn.Module:
    """Move ``params`` to host memory in place, each parameter a view into
    a host chunk laid out by :func:`_host_layout` (pinned when ``pin``, so
    the reloads copy at the bus's full rate)."""
    moved = [p for p in params.parameters() if p.device.type != "cpu"]
    sizes = [p.numel() * p.element_size() for p in moved]
    chunks, where = _host_layout(sizes)
    bufs = [torch.empty(n, dtype=torch.uint8, pin_memory=pin)
            for n in chunks]
    with torch.no_grad():
        for p, n, (c, off) in zip(moved, sizes, where):
            host = bufs[c][off:off + n].view(p.dtype)
            p.data = host.view(p.shape).copy_(p.data)
    return params


def _placed(params: nn.Module, device: torch.device,
            dtype: torch.dtype) -> nn.Module:
    """A copy of ``params`` on ``device``, each parameter cast to ``dtype``
    except those that stay fp32 at use (``layers.fp32_at_use``); the host
    copy is untouched."""
    memo = {}
    for name, p in params.named_parameters():
        t = p.detach().to(device, non_blocking=True)
        if not fp32_at_use(name):
            t = t.to(dtype)
        memo[id(p)] = nn.Parameter(t, requires_grad=False)
    return copy.deepcopy(params, memo)


class ServeEngine:
    def __init__(self, registry: Registry, device=None):
        self.registry = registry
        self.device = resolve_device(device)
        self._models: Dict[str, Model] = {}          # arch key -> Model
        self._weights: Dict[str, nn.Module] = {}     # app id -> fp32 (host)
        self._loaded: Dict[str, nn.Module] = {}      # app id -> device copy
        #: seconds of the last ``generate``'s prefill and decode phases
        self.last_times: Dict[str, float] = {}

    @staticmethod
    def _arch_key(cfg: ModelConfig) -> str:
        return f"{cfg.arch_id}/{cfg.n_layers}x{cfg.d_model}x{cfg.vocab}"

    def _model(self, cfg: ModelConfig) -> Model:
        k = self._arch_key(cfg)
        if k not in self._models:
            self._models[k] = build(cfg)
        return self._models[k]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- lifecycle (called by the warm pool's driver) -------------------------

    def load(self, app_id: str) -> float:
        """Put the app's weights on the device (made from the endpoint's
        seed, drawn as its ``init`` says, into the host store first, at its
        first load); returns the wall seconds taken."""
        # repro-lint: ignore[nondeterminism] -- load() measures the wall
        # seconds of a cold load; they are returned, no weight or token
        # depends on them
        t0 = time.perf_counter()
        ep = self.registry.get(app_id)
        if app_id not in self._weights:
            params = self._model(ep.cfg).init(ep.seed, device=self.device,
                                              scheme=ep.init)
            self._weights[app_id] = _to_host(
                params, pin=self.device.type == "cuda")
        self._loaded[app_id] = _placed(self._weights[app_id], self.device,
                                       compute_dtype(ep.cfg))
        self._sync()
        # repro-lint: ignore[nondeterminism] -- end of the load measurement
        return time.perf_counter() - t0

    def unload(self, app_id: str) -> None:
        """Drop the app's device copy; when the last loaded Mamba-2 (SSM)
        app goes, the SSD scan's scratch on the device goes with it."""
        if self._loaded.pop(app_id, None) is None:
            return
        ssm = lambda a: self.registry.get(a).cfg.family == "ssm"
        if ssm(app_id) and not any(ssm(a) for a in self._loaded):
            ssd_scan.release_scratch(self.device)

    def is_loaded(self, app_id: str) -> bool:
        return app_id in self._loaded

    # -- inference -------------------------------------------------------------

    def _frontend(self, cfg: ModelConfig, tokens: torch.Tensor):
        """The reference's modality frontend stub: zero frame embeddings
        [B, max(frontend_tokens, 1), d_model] (f32) for the
        encoder-decoder's encoder; ``None`` for every other family."""
        if cfg.family != "encdec":
            return None
        return torch.zeros((tokens.shape[0], max(cfg.frontend_tokens, 1),
                            cfg.d_model), dtype=torch.float32,
                           device=self.device)

    def generate(self, app_id: str, tokens, max_new: int = 8,
                 max_len: int = 128) -> Tuple[torch.Tensor, float]:
        """Greedy generation: one prefill, then ``max_new - 1`` decode
        steps. Returns (tokens [B, max_new], wall seconds); the seconds of
        each phase are left in ``last_times``.

        Requires the app to be loaded (the warm pool guarantees that)."""
        # repro-lint: ignore[nondeterminism] -- generate() reports measured
        # serving latency beside the (deterministic) tokens
        t0 = time.perf_counter()
        ep = self.registry.get(app_id)
        params = self._loaded[app_id]
        model = self._model(ep.cfg)
        tokens = torch.as_tensor(tokens, device=self.device)
        with torch.inference_mode():
            logits, cache = model.prefill(params, tokens, max_len,
                                          embeds=self._frontend(ep.cfg,
                                                                tokens))
            outs = [torch.argmax(logits, dim=-1)[:, 0]]
            self._sync()
            # repro-lint: ignore[nondeterminism] -- prefill/decode split
            t1 = time.perf_counter()
            for _ in range(max_new - 1):
                logits, cache = model.decode_step(params, outs[-1], cache)
                outs.append(torch.argmax(logits, dim=-1))
            result = torch.stack(outs, dim=1)
            self._sync()
        # repro-lint: ignore[nondeterminism] -- end of the measurement
        t2 = time.perf_counter()
        self.last_times = {"prefill_s": t1 - t0, "decode_s": t2 - t1}
        return result, t2 - t0
