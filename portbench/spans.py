"""The program's own ranges in a trace (``repro_torch.serving.spans``:
``pool.*``, ``serve.load``, ``serve.prefill``, ``serve.decode``,
``serve.capture``), on the trace's one clock and clipped to its span, and
the device's busy time inside them: what the per-phase metrics read."""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from .trace import Trace, _merged, union_us

__all__ = ["ranges", "without", "busy_us", "busy_share", "starts_inside",
           "host_us"]

Window = Tuple[float, float]


def ranges(t: Trace, name: str) -> List[Window]:
    """The host ranges named ``name`` that overlap the span, clipped to
    it, in start order."""
    lo, hi = t.span
    return sorted((max(s, lo), min(e, hi)) for n, s, e in t.host
                  if n == name and e > lo and s < hi)


def without(windows: Sequence[Window], holes: Sequence[Window]) \
        -> List[Window]:
    """``windows`` with every part that lies in one of ``holes`` cut
    out."""
    out = []
    for s, e in windows:
        pieces = [(s, e)]
        for hs, he in holes:
            pieces = [p for a, b in pieces
                      for p in ((a, min(b, hs)), (max(a, he), b))
                      if p[1] > p[0]]
        out += pieces
    return out


def busy_us(t: Trace, windows: Sequence[Window]) -> float:
    """Microseconds inside ``windows`` (disjoint) in which the device ran
    something: the union of its intervals, clipped to each window."""
    busy = _merged(t.device, t.span)
    starts = [s for s, _ in busy]
    ends = [e for _, e in busy]
    total = 0.0
    for ws, we in windows:
        for s, e in busy[bisect.bisect_right(ends, ws):
                         bisect.bisect_left(starts, we)]:
            total += min(e, we) - max(s, ws)
    return total


def busy_share(t: Trace, windows: Sequence[Window]) -> Optional[float]:
    """The share of the length of ``windows`` (disjoint) in which the
    device ran something; None where they have no length."""
    length = sum(e - s for s, e in windows)
    return busy_us(t, windows) / length if length > 0 else None


def starts_inside(t: Trace, windows: Sequence[Window]) -> int:
    """How many device intervals start inside one of ``windows``."""
    starts = sorted(s for _, s, _ in t.device)
    return sum(bisect.bisect_left(starts, we) - bisect.bisect_left(starts, ws)
               for ws, we in windows)


def host_us(t: Trace, prefix: str) -> float:
    """Microseconds of the span inside host ranges whose name starts with
    ``prefix`` (nested ones counted once)."""
    return union_us([iv for iv in t.host if iv[0].startswith(prefix)],
                    t.span)
