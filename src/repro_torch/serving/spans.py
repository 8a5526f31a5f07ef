"""Named ranges of the serve path on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range while a
profiler is recording and does nothing otherwise: the profiler is the
switch, the clock and the store, and its trace is the write-out. The check
is one C call; entering ``record_function`` with no profiler running costs
some fifty times as much, so every range of the serve path goes through
here.

The ranges (``warmpool.WarmPool``, ``engine.ServeEngine``,
``engine.Executable``):

  * ``pool.tick``, ``pool.on_request``, ``pool.on_request_end``: each call's
    whole body (``on_request`` runs a ``tick`` inside its range);
  * ``serve.load``: ``ServeEngine.load`` through its synchronisation;
  * ``serve.prefill``: ``generate``'s prefill through the synchronisation
    after it;
  * ``serve.decode``: ``generate``'s decode loop through its
    synchronisation, and inside it, at an entry's first request on the
    card, ``serve.capture``: the eager first step and the graph's capture.

Because ``generate`` and ``load`` synchronise before their ranges close,
the device work a phase launched runs inside its range on the trace's one
clock.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while the profiler is
    on, else a shared no-op."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
