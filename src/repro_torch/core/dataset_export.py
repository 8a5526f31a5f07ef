"""Sanitized-trace export in the AzurePublicDataset format (the port of
``repro/core/dataset_export.py``: csv and numpy over the port's
:class:`~repro_torch.core.workload.Trace`; its files are the reference's
byte for byte on the same trace).

The paper's fourth contribution is the released dataset
(github.com/Azure/AzurePublicDataset: `invocations_per_function_md.anon`,
`function_durations_percentiles.anon`, `app_memory_percentiles.anon`). This
module writes generated traces in the same schema so downstream tools built
against the real dataset run unchanged on our synthetic ones — and so our
generator can be validated field-by-field against the published schema.

Schema (per the dataset documentation):
  * invocations:  HashOwner, HashApp, HashFunction, Trigger, 1..1440 columns
    of per-minute counts (one file per day);
  * durations:    HashOwner, HashApp, HashFunction, Average, Count, Minimum,
    Maximum, percentile_Average_{0,1,25,50,75,99,100};
  * memory:       HashOwner, HashApp, SampleCount, AverageAllocatedMb,
    AverageAllocatedMb_pct{1,5,25,50,75,95,99,100}.
"""
from __future__ import annotations

import csv
import hashlib
import os
from typing import List

import numpy as np

from .workload import MINUTES_PER_DAY, Trace

__all__ = ["export", "load_invocations"]

_PCT_DUR = (0, 1, 25, 50, 75, 99, 100)
_PCT_MEM = (1, 5, 25, 50, 75, 95, 99, 100)


def _hash(s: str) -> str:
    return hashlib.sha1(s.encode()).hexdigest()[:32]


def export(trace: Trace, out_dir: str, owner: str = "repro") -> List[str]:
    """Write the three dataset files; returns the paths.

    Requires an eager trace (``AppSpec`` metadata feeds the trigger,
    duration, and memory columns): ``generate_trace(...)`` or
    ``WorkloadSpec.materialize(eager=True)``.
    """
    if trace.specs is None:
        raise ValueError(
            "dataset export needs an eager trace with AppSpecs; use "
            "generate_trace(...) or spec.materialize(eager=True)")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    n_days = max(int(np.ceil(trace.duration_minutes / MINUTES_PER_DAY)), 1)

    # --- invocations per function per minute, one file per day -------------
    for day in range(n_days):
        path = os.path.join(out_dir,
                            f"invocations_per_function_md.anon.d{day + 1:02d}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["HashOwner", "HashApp", "HashFunction", "Trigger"]
                       + [str(i) for i in range(1, 1441)])
            lo = day * MINUTES_PER_DAY
            for i, spec in enumerate(trace.specs):
                t = trace.events(i)
                in_day = t[(t >= lo) & (t < lo + MINUTES_PER_DAY)] - lo
                counts = np.bincount(in_day.astype(int),
                                     minlength=1440)[:1440]
                if counts.sum() == 0:
                    continue
                w.writerow([_hash(owner), _hash(spec.app_id),
                            _hash(spec.app_id + "/f0"), spec.triggers[0]]
                           + counts.tolist())
        paths.append(path)

    # --- duration percentiles ------------------------------------------------
    path = os.path.join(out_dir, "function_durations_percentiles.anon.csv")
    rng = np.random.default_rng(0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["HashOwner", "HashApp", "HashFunction", "Average",
                    "Count", "Minimum", "Maximum"]
                   + [f"percentile_Average_{p}" for p in _PCT_DUR])
        for i, spec in enumerate(trace.specs):
            n = max(len(trace.events(i)), 1)
            # per-invocation durations ~ lognormal around the app average
            samples = spec.exec_time_s * np.exp(rng.normal(0, 0.4, min(n, 256)))
            ms = samples * 1e3
            w.writerow([_hash(owner), _hash(spec.app_id),
                        _hash(spec.app_id + "/f0"),
                        round(float(ms.mean()), 2), n,
                        round(float(ms.min()), 2), round(float(ms.max()), 2)]
                       + [round(float(np.percentile(ms, p)), 2)
                          for p in _PCT_DUR])
    paths.append(path)

    # --- memory percentiles ----------------------------------------------------
    path = os.path.join(out_dir, "app_memory_percentiles.anon.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["HashOwner", "HashApp", "SampleCount",
                    "AverageAllocatedMb"]
                   + [f"AverageAllocatedMb_pct{p}" for p in _PCT_MEM])
        for i, spec in enumerate(trace.specs):
            n = max(len(trace.events(i)), 1)
            samples = spec.memory_mb * np.exp(rng.normal(0, 0.15, 64))
            w.writerow([_hash(owner), _hash(spec.app_id), n,
                        round(float(samples.mean()), 2)]
                       + [round(float(np.percentile(samples, p)), 2)
                          for p in _PCT_MEM])
    paths.append(path)
    return paths


def load_invocations(path: str):
    """Parse an invocations file back into (app_hashes, counts [n, 1440])."""
    apps, rows = [], []
    with open(path) as f:
        r = csv.reader(f)
        header = next(r)
        for row in r:
            apps.append(row[1])
            rows.append(np.asarray(row[4:], dtype=np.int64))
    return apps, (np.stack(rows) if rows else np.zeros((0, 1440), np.int64))
