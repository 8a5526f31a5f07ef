"""Columnar application table for the fleet-scale cluster simulator.

The per-event cluster oracle (:mod:`repro_torch.serving.cluster_sim`)
consumes an eager trace: a Python list of ``AppSpec`` objects next to a
Python list of time arrays, fine at 10^4 apps and prohibitive at 10^6.
``AppTable`` is the columnar form: app-id hashes, exec times, memory sizes
and image weights as flat arrays next to the padded ``[n_apps, max_ev]``
time frame, built straight from a ``WorkloadSpec`` (no eager
materialisation, no per-app Python objects) or from any ``Trace``.

Population columns come from
:func:`repro_torch.core.workload_spec.population_columns`, which replays
only the per-block population draw of the generator: the values an eager
materialisation writes into ``AppSpec`` objects, at array speed.

Worker placement is a column too: ``worker_assignment`` reproduces the
oracle's affinity balancer exactly (least-loaded-at-first-sight over a
fleet of initially empty workers is round-robin in order of first arrival)
and offers FNV-1a hash placement as the stateless alternative. Host numpy
throughout; the port of ``repro/serving/apptable.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.workload import MINUTES_PER_DAY, AppSpec, Trace
from ..core.workload_spec import WorkloadSpec, population_columns
from .registry import ModelEndpoint, Registry

__all__ = ["AppTable", "fnv1a64", "fnv1a64_app_indices"]

# Default image weight: the app's allocated memory, 1 MB = 2**20 bytes.
_BYTES_PER_MB = 2 ** 20

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_U64_MASK = 0xFFFFFFFFFFFFFFFF


def fnv1a64(s: str) -> int:
    """FNV-1a 64-bit hash of a string (the scalar reference)."""
    h = _FNV_OFFSET
    for b in s.encode():
        h = ((h ^ b) * _FNV_PRIME) & _U64_MASK
    return h


_APP_PREFIX_HASH = fnv1a64("app-")
_POW10 = 10 ** np.arange(1, 19, dtype=np.int64)


def fnv1a64_app_indices(idx: np.ndarray) -> np.ndarray:
    """Vectorized :func:`fnv1a64` of the canonical ``app-%06d`` id pattern.

    Folds the shared ``"app-"`` prefix once, then the decimal digits
    column-wise per id width (``%06d`` pads to 6 digits; wider fleets grow
    naturally). Bit-identical to ``fnv1a64(f"app-{i:06d}")`` per element.
    """
    idx = np.asarray(idx, np.int64)
    if np.any(idx < 0):
        raise ValueError("app indices must be non-negative")
    out = np.empty(idx.shape, np.uint64)
    width = np.maximum(np.searchsorted(_POW10, idx, side="right") + 1, 6)
    prime = np.uint64(_FNV_PRIME)
    with np.errstate(over="ignore"):
        for w in np.unique(width):
            m = width == w
            v = idx[m]
            h = np.full(v.shape, np.uint64(_APP_PREFIX_HASH))
            for p in range(int(w) - 1, -1, -1):
                digit = ((v // 10 ** p) % 10 + ord("0")).astype(np.uint64)
                h = (h ^ digit) * prime
            out[m] = h
    return out


def _column(value, n: int, name: str, dtype) -> np.ndarray:
    arr = np.asarray(value, dtype)
    if arr.ndim == 0:
        return np.full(n, arr, dtype)
    if arr.shape != (n,):
        raise ValueError(f"{name} must be scalar or shape ({n},), "
                         f"got {arr.shape}")
    return np.ascontiguousarray(arr)


@dataclasses.dataclass(frozen=True)
class AppTable:
    """Columnar per-app fleet state: the cluster engine's input format.

    ``times`` is the padded ``[n_apps, max_ev]`` invocation frame in minutes
    (+inf padded, sorted per row); treat all arrays as read-only.

    ``weight_bytes`` feeds both the cold-start latency model and the HBM
    occupancy replay (``cluster_vector`` phase D). Eviction ties break on
    the *string* app id, exactly like the oracle's heap — canonical
    ``app-%06d`` ids compare lexicographically in index order up to one
    million apps, which the engine exploits; tables carrying custom
    ``app_ids`` fall back to explicit lexicographic ranks.
    """

    times: np.ndarray          # [n, M] minutes, sorted, +inf padded
    counts: np.ndarray         # [n] int32 valid events per app
    exec_s: np.ndarray         # [n] float64 mean execution seconds
    memory_mb: np.ndarray      # [n] float64 allocated memory
    weight_bytes: np.ndarray   # [n] int64 model-image bytes (cold-start cost)
    app_hash: np.ndarray       # [n] uint64 FNV-1a of the app id
    duration_minutes: float
    app_ids: Optional[Tuple[str, ...]] = None   # only when non-canonical

    @property
    def n_apps(self) -> int:
        return int(self.times.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.counts.sum())

    def app_id(self, i: int) -> str:
        if self.app_ids is not None:
            return self.app_ids[i]
        return f"app-{i:06d}"

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_spec(cls, spec: WorkloadSpec, *, exec_s=None, memory_mb=None,
                  weight_bytes=None, trace: Optional[Trace] = None
                  ) -> "AppTable":
        """Build from a declarative workload — no eager AppSpec loop.

        ``'patterns'`` specs pull exec/memory straight from the population
        columns; ``'uniform'`` specs carry no population, so ``exec_s`` and
        ``memory_mb`` must be given (scalar or per-app). ``trace`` may pass
        an already-materialized trace of the same spec to skip regenerating.
        """
        if trace is None:
            trace = spec.materialize()
        if exec_s is None or memory_mb is None:
            pop = population_columns(spec)     # raises for 'uniform'
            exec_s = pop["execs"] if exec_s is None else exec_s
            memory_mb = pop["memory"] if memory_mb is None else memory_mb
        return cls.from_trace(trace, exec_s=exec_s, memory_mb=memory_mb,
                              weight_bytes=weight_bytes)

    @classmethod
    def from_trace(cls, trace: Trace, *, exec_s=None, memory_mb=None,
                   weight_bytes=None) -> "AppTable":
        """Build from any Trace (eager or padded-only).

        Eager traces supply exec/memory (and app ids) from their AppSpecs;
        padded-only traces use the canonical ``app-%06d`` ids and require
        explicit ``exec_s`` / ``memory_mb`` (scalar or per-app arrays).
        """
        times, counts = trace.to_padded()
        n = trace.n_apps
        ids = None
        if trace.specs is not None:
            if exec_s is None:
                exec_s = np.array([s.exec_time_s for s in trace.specs],
                                  np.float64)
            if memory_mb is None:
                memory_mb = np.array([s.memory_mb for s in trace.specs],
                                     np.float64)
            ids = tuple(s.app_id for s in trace.specs)
            if all(a == f"app-{i:06d}" for i, a in enumerate(ids)):
                ids = None                     # canonical: no need to store
        if exec_s is None or memory_mb is None:
            raise ValueError(
                "padded-only traces carry no per-app metadata; pass exec_s "
                "and memory_mb (scalar or [n_apps] arrays) to AppTable")
        exec_col = _column(exec_s, n, "exec_s", np.float64)
        mem_col = _column(memory_mb, n, "memory_mb", np.float64)
        if weight_bytes is None:
            wb_col = np.round(mem_col * _BYTES_PER_MB).astype(np.int64)
        else:
            wb_col = _column(weight_bytes, n, "weight_bytes", np.int64)
        if ids is None:
            app_hash = fnv1a64_app_indices(np.arange(n))
        else:
            app_hash = np.array([fnv1a64(a) for a in ids], np.uint64)
        return cls(times=times, counts=np.asarray(counts, np.int32),
                   exec_s=exec_col, memory_mb=mem_col, weight_bytes=wb_col,
                   app_hash=app_hash,
                   duration_minutes=float(trace.duration_minutes),
                   app_ids=ids)

    # -- worker placement -----------------------------------------------------

    def worker_assignment(self, n_workers: int,
                          balancing: str = "affinity") -> np.ndarray:
        """Per-app worker index under the requested balancing mode.

        ``"affinity"`` reproduces the scalar oracle's
        least-loaded-at-first-sight placement: every new app adds exactly
        one resident entry to its worker, and argmin ties break toward the
        lowest index, so placement is round-robin in order of first arrival
        (ties by app index, matching the oracle's (time, index) event sort).
        ``"hash"`` is stateless FNV-1a placement. Apps with zero events are
        assigned worker 0; they generate no load.
        """
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        n = self.n_apps
        if balancing == "hash":
            return (self.app_hash % np.uint64(n_workers)).astype(np.int64)
        if balancing != "affinity":
            raise ValueError(
                f"unknown balancing {balancing!r}; use 'affinity' or 'hash'")
        assign = np.zeros(n, np.int64)
        active = self.counts > 0
        t0 = np.where(active, self.times[:, 0] if self.times.shape[1] else
                      np.inf, np.inf)
        order = np.lexsort((np.arange(n), t0))
        n_active = int(active.sum())
        assign[order[:n_active]] = np.arange(n_active) % n_workers
        return assign

    # -- bridges to the scalar oracle -----------------------------------------

    def to_trace(self) -> Trace:
        """Eager Trace view (float64 times + AppSpecs) for the scalar oracle.

        Pattern metadata the table does not keep (pattern class, period,
        trigger mix) is filled with placeholders — the cluster simulator
        reads only ``app_id`` and ``exec_time_s``.
        """
        days = max(self.duration_minutes / MINUTES_PER_DAY, 1e-12)
        times = [np.asarray(self.times[i, : int(c)], np.float64)
                 for i, c in enumerate(self.counts)]
        specs = [AppSpec(app_id=self.app_id(i), pattern="poisson",
                         rate_per_day=float(self.counts[i]) / days,
                         period_minutes=0.0,
                         exec_time_s=float(self.exec_s[i]),
                         memory_mb=float(self.memory_mb[i]), n_functions=1,
                         triggers=("http",))
                 for i in range(self.n_apps)]
        return Trace(specs=specs, times=times,
                     duration_minutes=self.duration_minutes)

    def to_registry(self) -> Registry:
        """Registry of weight-only endpoints for the scalar oracle."""
        reg = Registry()
        for i in range(self.n_apps):
            reg.register(ModelEndpoint(app_id=self.app_id(i), cfg=None,
                                       weight_bytes=int(self.weight_bytes[i])))
        return reg
