"""The reduction of a profiler trace: device intervals, their union, the
idle gaps and what the host was doing in them.

A :class:`Trace` holds, on one clock in microseconds, the device's
activities (kernels, copies and sets), the host's ranges (the benchmark's
own spans, the operators and runtime calls) and the traced span. Built
from a ``torch.profiler`` run by :func:`from_profiler`, or by hand in the
tests.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Trace", "DEVICE_KINDS", "from_profiler", "union_us", "busy_s",
           "window_s", "idle_share", "device_ops", "idle_gaps", "kernels"]

Interval = Tuple[str, float, float]          # (name, start_us, end_us)

#: The profiler's activity types that are the device at work.
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    device: List[Interval]
    host: List[Interval]
    span: Tuple[float, float]


def from_profiler(prof, span_name: str) -> Optional[Trace]:
    """The trace of a stopped ``torch.profiler.profile`` whose window is the
    host range ``span_name``; None where the profiler recorded no such
    range. The device's activities are its kernels, copies and sets: by
    the event's activity type where the profiler gives one, else every
    device event whose name is not also a host range's (the device's copy
    of a ``record_function`` range)."""
    events = list(prof.profiler.kineto_results.events())
    host, dev, span = [], [], None
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            start = e.start_ns() / 1e3
            host.append((e.name(), start, start + e.duration_ns() / 1e3))
            if e.name() == span_name:
                span = host[-1][1:]
    if span is None:
        return None
    host_names = {name for name, _, _ in host}
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else None
        if kind in DEVICE_KINDS or (kind is None and e.name()
                                    not in host_names):
            start = e.start_ns() / 1e3
            dev.append((e.name(), start, start + e.duration_ns() / 1e3))
    return Trace(dev, host, span)


def _clipped(iv: Sequence[Interval], span) -> List[Tuple[float, float]]:
    lo, hi = span
    return sorted((max(s, lo), min(e, hi)) for _, s, e in iv
                  if e > lo and s < hi)


def _merged(iv: Sequence[Interval], span) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in _clipped(iv, span):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_us(iv: Sequence[Interval], span) -> float:
    """Length of the union of the intervals inside ``span``."""
    return sum(e - s for s, e in _merged(iv, span))


def busy_s(t: Trace) -> float:
    """Seconds of the span in which the device ran something."""
    return union_us(t.device, t.span) / 1e6


def window_s(t: Trace) -> float:
    return (t.span[1] - t.span[0]) / 1e6


def idle_share(t: Trace) -> float:
    """1 - (union of the device intervals) / (the span)."""
    return 1.0 - busy_s(t) / window_s(t)


def kernels(t: Trace, needle: str) -> List[Interval]:
    """The device intervals whose name holds ``needle``, in start order."""
    return sorted((iv for iv in t.device if needle in iv[0]),
                  key=lambda iv: iv[1])


def device_ops(t: Trace, n: int = 10) -> List[List]:
    """The ``n`` device operations (by name) with the most seconds."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in t.device:
        tot[name] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(t: Trace, n: int = 10) -> List[List]:
    """The device's idle time inside the span, by what the host was doing:
    each gap cut where one of the benchmark's own spans (``portbench.*``)
    begins or ends, each piece named by the innermost own span at its
    middle and the innermost other host range there (an operator, a runtime
    call); the ``n`` names with the most idle seconds."""
    busy = _merged(t.device, t.span)
    gaps, prev = [], t.span[0]
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t.span[1] > prev:
        gaps.append((prev, t.span[1]))
    cuts = sorted({x for name, s, e in t.host if name.startswith("portbench.")
                   for x in (s, e)})
    pieces = []
    for s, e in gaps:
        inner = cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)]
        edges = [s] + inner + [e]
        pieces += list(zip(edges, edges[1:]))
    host = sorted(t.host, key=lambda iv: iv[1])
    tot: Dict[str, float] = collections.defaultdict(float)
    open_: List[Tuple[float, float, str]] = []      # heap of (end, start, name)
    i = 0
    for s, e in pieces:
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(open_, (host[i][2], host[i][1], host[i][0]))
            i += 1
        while open_ and open_[0][0] < mid:
            heapq.heappop(open_)
        # innermost: the latest start, then the earliest end
        own = [(hs, -he, name) for he, hs, name in open_
               if name.startswith("portbench.")]
        other = [(hs, -he, name) for he, hs, name in open_
                 if not name.startswith("portbench.")]
        label = max(own)[2] if own else "(no span)"
        if other:
            label += " > " + max(other)[2]
        tot[label] += (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
