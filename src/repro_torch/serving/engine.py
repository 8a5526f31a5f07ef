"""Serve engine: runs real model steps for loaded endpoints.

The port of ``repro/serving/engine.py``: a per-app host weight store (made
from the endpoint's seed at first load, each parameter in the dtype it is
served in), the device copies of the loaded apps, an executable cache, and
greedy batched decode. A cold start is the weights' trip to the device
(plus, at an app's first load, their initialisation), and the first
request of each (app, ``max_len``, batch) after a load pays its entry's
capture.

The executable cache (the reference's ``_executables``, a ``jax.jit`` of
prefill and decode per arch and ``max_len``): an :class:`Executable` per
(app, ``max_len``, batch), holding the decode state that its steps read
and write in place (copied in from each request's eager prefill) and, on
the card, a ``torch.cuda.CUDAGraph`` of one greedy decode step captured on
that state. The reference passes the weights to its compiled steps as
arguments; a CUDA graph bakes in the addresses it read, so an entry
belongs to the loaded copy of its app's weights, and ``unload`` and every
``load`` drop the app's entries. The decode step reads its position on the
device only (``layers.step_positions``, ``write_rows``; the decode kernel
takes ``kv_len`` as a device tensor), so one graph serves every step of
every request. The entry shares with the others of its arch what the port
shares anyway: the built ``Model`` and the kernels' builds. On the CPU an
entry runs the same steps eagerly.

Under a running profiler, ``load`` and ``generate``'s prefill and decode
(and a capture within the decode) are named ranges of its trace
(:mod:`.spans`), each closed after the phase's synchronisation.

Every family serves: dense (Qwen2; a VLM backbone serves text only, as in
the reference), MoE (OLMoE), encoder-decoder (SeamlessM4T, whose encoder
gets the reference's frontend stub: zero frames), hybrid (RecurrentGemma)
and SSM (Mamba-2). Each parameter is served in the activation dtype,
except those the model keeps in fp32 at use (``layers.FP32_AT_USE``: the
``rmsnorm`` scales, the RG-LRU ``lam``, Mamba-2's ``A_log`` and
``dt_bias``, the MoE router's ``router.w``). Casting every other parameter
at use, as the reference does, gives the same numbers; casting once avoids
re-reading fp32 weights on every decode step, and matches the registry's
cost model, which counts ``2 * n_params`` bytes per image.

The host store holds each parameter in that served dtype too, so a reload
copies only the bytes the device keeps (15.2 GB for Qwen2-7B in bf16,
against 30.5 GB of fp32): the engine's own draw is cast on its device
before it goes to the host, and an fp32 image handed in (``_weights[app]``
set from outside) is narrowed at its app's next ``load``, from the device
copy that load made. The fp32 to bf16 cast rounds to nearest even on
either side, so the device weights are the same bit for bit.
``last_load_bytes`` holds the host bytes the last ``load`` copied.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import ctx
from ..kernels import decode_attention, flash_attention, rglru_scan, ssd_scan
from ..models import Model, build
from ..models.layers import compute_dtype, fp32_at_use
from .registry import Registry
from .spans import span

__all__ = ["ServeEngine", "Executable"]

#: The model kernels whose wrappers count their launches (``LAUNCHES`` and,
#: where they keep one, ``LAUNCHES_BY_FORM``). A graph replay makes no
#: Python call, so an entry takes back what its capture counted (nothing
#: ran then) and adds it once per replay.
_COUNTED = (flash_attention, decode_attention, rglru_scan, ssd_scan)


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


def _host_views(specs, pin: bool):
    """Views of new host chunks laid out by :func:`_host_layout` (pinned
    when ``pin``), one of each (shape, dtype) of ``specs``."""
    sizes = [math.prod(shape) * dt.itemsize for shape, dt in specs]
    chunks, where = _host_layout(sizes)
    bufs = [torch.empty(n, dtype=torch.uint8, pin_memory=pin)
            for n in chunks]
    return [bufs[c][off:off + n].view(dt).view(shape)
            for (shape, dt), n, (c, off) in zip(specs, sizes, where)]


def _to_host(params: nn.Module, pin: bool,
             dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Move ``params`` to host memory in place, each parameter a view into
    a host chunk laid out by :func:`_host_layout` (pinned when ``pin``, so
    the reloads copy at the bus's full rate). With ``dtype``, each
    parameter is first cast on its own device to the dtype :func:`_placed`
    gives it, so the host holds the served bytes."""
    moved, dts = [], []
    for name, p in params.named_parameters():
        dt = p.dtype if dtype is None or fp32_at_use(name) else dtype
        if p.device.type != "cpu" or dt != p.dtype:
            moved.append(p)
            dts.append(dt)
    views = _host_views([(p.shape, dt) for p, dt in zip(moved, dts)], pin)
    with torch.no_grad():
        for p, dt, host in zip(moved, dts, views):
            p.data = host.copy_(p.data.to(dt))
    return params


def _narrow(params: nn.Module, placed: nn.Module, pin: bool) -> None:
    """Lay the host image ``params`` out anew in place, each parameter
    holding its copy in ``placed`` (the device copy :func:`_placed` just
    made of it): the image in the dtypes it is served in. The old chunks
    are freed first, so that a card's pinned allocator reuses its cached
    blocks for the new ones; then the cached blocks left unused go back to
    the system."""
    copies = dict(placed.named_parameters())
    named = list(params.named_parameters())
    with torch.no_grad():
        for _, p in named:
            p.data = torch.empty(0, dtype=p.dtype)
        views = _host_views([(copies[n].shape, copies[n].dtype)
                             for n, _ in named], pin)
        for (n, p), host in zip(named, views):
            p.data = host.copy_(copies[n])
    if pin:
        torch._C._host_emptyCache()


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


def _launch_counts():
    return [(m.LAUNCHES, dict(getattr(m, "LAUNCHES_BY_FORM", {})))
            for m in _COUNTED]


def _add_launches(delta, sign: int = 1) -> None:
    for m, (n, forms) in zip(_COUNTED, delta):
        m.LAUNCHES += sign * n
        for form, c in forms.items():
            m.LAUNCHES_BY_FORM[form] += sign * c


def _tree(fn, a, *rest):
    """``fn`` over the tensor leaves of a decode state (dicts and lists of
    tensors, ``pos`` among them), with the same leaves of ``rest``."""
    if isinstance(a, dict):
        return {k: _tree(fn, v, *(r[k] for r in rest)) for k, v in a.items()}
    if isinstance(a, list):
        return [_tree(fn, *leaves) for leaves in zip(a, *rest)]
    return fn(a, *rest)


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it is contiguous and owns all of its storage, else a
    contiguous copy: a view kept as an entry's state would keep its base
    alive (the hybrid's conv tails are views of a prompt's projection)."""
    whole = t.is_contiguous() and t.storage_offset() == 0 and \
        t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if whole else t.clone(memory_format=torch.contiguous_format)


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    if dst is not src:
        dst.copy_(src)


class Executable:
    """One entry of the executable cache: greedy decode of ``batch``
    sequences of one loaded app with a KV capacity of ``max_len``.

    ``state`` is the decode state its steps read and write in place:
    adopted from the first request's prefill (each tensor that is a view
    is copied out, :func:`_own`), and from then on each request's prefill
    state is copied into it. ``token`` [B] holds the last greedy tokens and
    ``logits`` [B, vocab] the last step's logits. On the CPU :meth:`decode`
    runs the step eagerly. On the card its first call runs the step
    eagerly on a side stream (the warm-up: the kernels' libraries and
    scratch and cuBLAS's workspace are made outside the graph's pool),
    then captures one step, its state copied back into ``state``, the
    argmax into ``token`` and ``pos`` advanced inside the graph, and every
    later call replays it. A capture that fails raises: there is no eager
    path behind it on the card."""

    def __init__(self, model: Model, params: nn.Module, max_len: int,
                 device: torch.device):
        self.model, self.params = model, params
        self.max_len, self.device = max_len, device
        self.state = self.token = self.logits = None
        self.graph = None
        #: seconds the capture took (0.0 until it happened)
        self.capture_s = 0.0
        self._per_replay = None      # each counted kernel's launches a replay
        self._scratch = []           # the kernel scratch its graph reads

    def prefill(self, tokens: torch.Tensor, embeds=None) -> torch.Tensor:
        """The eager prefill of ``tokens`` [B, S] into the entry's state;
        returns the first greedy tokens [B]."""
        with torch.inference_mode():
            logits, state = self.model.prefill(self.params, tokens,
                                               self.max_len, embeds=embeds)
            token = torch.argmax(logits, dim=-1)[:, 0]
            if self.state is None:
                self.state, self.token = _tree(_own, state), _own(token)
            else:
                _tree(_copy_into, self.state, state)
                self.token.copy_(token)
            return self.token.clone()

    def _step(self) -> torch.Tensor:
        logits, state = self.model.decode_step(self.params, self.token,
                                               self.state)
        _tree(_copy_into, self.state, state)
        self.token.copy_(torch.argmax(logits, dim=-1))
        return logits

    def decode(self) -> torch.Tensor:
        """One greedy decode step from the entry's state; returns the next
        tokens [B] (``logits`` holds the step's logits)."""
        with torch.inference_mode():
            if self.graph is not None:
                self.graph.replay()
                _add_launches(self._per_replay)
            elif self.device.type == "cuda":
                with span("serve.capture"):
                    self._capture()
            else:
                self.logits = self._step()
            return self.token.clone()

    def _capture(self) -> None:
        """The first step eagerly on a side stream, then the capture of the
        next on that stream; the eager step's logits are copied into the
        graph's output, which ``logits`` is from then on."""
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = self._step()
            # repro-lint: ignore[nondeterminism] -- the capture's seconds
            # are reported (capture_s); no token depends on them
            t0 = time.perf_counter()
            before = _launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = self._step()
            delta = [(n1 - n0, {f: c - f0[f] for f, c in f1.items()})
                     for (n0, f0), (n1, f1) in zip(before, _launch_counts())]
            _add_launches(delta, -1)             # recorded, not run
            out.copy_(logits)
            side.synchronize()
            # repro-lint: ignore[nondeterminism] -- end of the capture
            self.capture_s = time.perf_counter() - t0
        main.wait_stream(side)
        self.graph, self.logits = graph, out
        self._per_replay = delta
        self._scratch = decode_attention.scratch_tensors(self.device)

    def close(self) -> None:
        """Free the graph's memory pool and drop the state."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.state = self.token = self.logits = None
        self._scratch = []


class ServeEngine:
    def __init__(self, registry: Registry, device=None):
        self.registry = registry
        self.device = resolve_device(device)
        self._models: Dict[str, Model] = {}          # arch key -> Model
        #: app id -> host image, each parameter in its served dtype
        self._weights: Dict[str, nn.Module] = {}
        self._loaded: Dict[str, nn.Module] = {}      # app id -> device copy
        #: (app id, max_len, batch) -> entry, of the loaded copy only
        self._exec_cache: Dict[Tuple[str, int, int], Executable] = {}
        #: seconds of the last ``generate``'s prefill and decode phases and,
        #: on the card, of its capture (0.0 where its entry was cached)
        self.last_times: Dict[str, float] = {}
        #: host bytes the last ``load`` copied to the device
        self.last_load_bytes = 0

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

    def _executables(self, app_id: str, max_len: int,
                     batch: int) -> Executable:
        """The entry of (``app_id``, ``max_len``, ``batch``), made at first
        use for the app's loaded copy (a ``KeyError`` where it is not
        loaded)."""
        key = (app_id, max_len, batch)
        entry = self._exec_cache.get(key)
        if entry is None:
            entry = self._exec_cache[key] = Executable(
                self._model(self.registry.get(app_id).cfg),
                self._loaded[app_id], max_len, self.device)
        return entry

    def _drop_executables(self, app_id: str) -> None:
        for key in [k for k in self._exec_cache if k[0] == app_id]:
            self._exec_cache.pop(key).close()

    # -- lifecycle (called by the warm pool's driver) -------------------------

    def load(self, app_id: str) -> float:
        """Put the app's weights on the device (made from the endpoint's
        seed, drawn as its ``init`` says, into the host store first, at its
        first load); returns the wall seconds taken. A host image not yet
        in its served dtypes (an fp32 one handed in) is narrowed to them
        after the copy, from the device copy."""
        # repro-lint: ignore[nondeterminism] -- load() measures the wall
        # seconds of a cold load; they are returned, no weight or token
        # depends on them
        t0 = time.perf_counter()
        ep = self.registry.get(app_id)
        dtype, pin = compute_dtype(ep.cfg), self.device.type == "cuda"
        with span("serve.load"):
            self._drop_executables(app_id)       # they read the old copy
            if app_id not in self._weights:
                params = self._model(ep.cfg).init(ep.seed, device=self.device,
                                                  scheme=ep.init)
                self._weights[app_id] = _to_host(params, pin, dtype)
            host = self._weights[app_id]
            self.last_load_bytes = sum(p.numel() * p.element_size()
                                       for p in host.parameters())
            placed = self._loaded[app_id] = _placed(host, self.device, dtype)
            self._sync()
            if any(p.dtype != q.dtype for p, q in zip(host.parameters(),
                                                       placed.parameters())):
                _narrow(host, placed, pin)
        # repro-lint: ignore[nondeterminism] -- end of the load measurement
        return time.perf_counter() - t0

    def unload(self, app_id: str) -> None:
        """Drop the app's device copy and its executable-cache entries (and
        their graphs' memory); when the last loaded Mamba-2 (SSM) app goes,
        the SSD scan's scratch on the device goes with it."""
        self._drop_executables(app_id)
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
        steps through the executable cache's entry of (app, ``max_len``,
        batch): on the card one eager step and a capture at the entry's
        first request, graph replays otherwise. Returns (tokens [B,
        max_new], wall seconds); the seconds of the prefill and decode
        phases are left in ``last_times``, and on the card those of the
        capture too (``capture_s``, not counted in ``decode_s``).

        Requires the app to be loaded (the warm pool guarantees that).
        Raises before any step where the prompt and the new tokens need
        more than ``max_len`` cache positions, and under an active mesh
        (the distributed decode is ``distributed.dist_decode``'s)."""
        # repro-lint: ignore[nondeterminism] -- generate() reports measured
        # serving latency beside the (deterministic) tokens
        t0 = time.perf_counter()
        if ctx.active_mesh() is not None:
            raise RuntimeError("ServeEngine.generate runs on one device; "
                               "under a mesh decode through the model's "
                               "decode_step (distributed.dist_decode)")
        ep = self.registry.get(app_id)
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        if S + max_new - 1 > max_len:
            raise ValueError(f"generate: {S} prompt tokens and {max_new} new "
                             f"ones need {S + max_new - 1} cache positions, "
                             f"more than max_len {max_len}")
        entry = self._executables(app_id, max_len, B)
        capture = self.device.type == "cuda" and entry.graph is None \
            and max_new > 1
        with torch.inference_mode():
            with span("serve.prefill"):
                embeds = self._frontend(ep.cfg, tokens)
                outs = [entry.prefill(tokens, embeds)]
                self._sync()
            # repro-lint: ignore[nondeterminism] -- prefill/decode split
            t1 = time.perf_counter()
            with span("serve.decode"):
                for _ in range(max_new - 1):
                    outs.append(entry.decode())
                result = torch.stack(outs, dim=1)
                self._sync()
        # repro-lint: ignore[nondeterminism] -- end of the measurement
        t2 = time.perf_counter()
        capture_s = entry.capture_s if capture else 0.0
        self.last_times = {"prefill_s": t1 - t0,
                           "decode_s": t2 - t1 - capture_s}
        if self.device.type == "cuda":
            self.last_times["capture_s"] = capture_s
        return result, t2 - t0
