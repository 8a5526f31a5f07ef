"""Export a generated trace in the AzurePublicDataset format (the port of
``examples/export_dataset.py``) — the analog of the paper's released
sanitized dataset. Tools written against the public dataset's format run
unchanged on these files.

  PYTHONPATH=src python -m repro_torch.examples.export_dataset --apps 200 --days 2

The trace is generated on the host (numpy); ``--device`` is accepted like
every twin's and resolved (the card by default, raising without one), but
no step of the export runs on a device.
"""
from __future__ import annotations

import argparse
from typing import List, Tuple

from ..core.dataset_export import export
from ..core.workload import generate_trace
from ..device import resolve_device

__all__ = ["export_trace", "main"]


def export_trace(apps: int = 200, days: float = 2.0, seed: int = 0,
                 out: str = "results/dataset") -> Tuple[int, List[str]]:
    """Generate the trace and write its files under ``out``; returns the
    invocation count and the written paths."""
    trace = generate_trace(apps, days=days, seed=seed)
    paths = export(trace, out)
    return sum(len(t) for t in trace.times), paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--apps", type=int, default=200)
    ap.add_argument("--days", type=float, default=2.0)
    ap.add_argument("--out", default="results/dataset")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    n_inv, paths = export_trace(args.apps, args.days, args.seed, args.out)
    print(f"exported {args.apps} apps / {n_inv:,} invocations:")
    for p in paths:
        print(" ", p)


if __name__ == "__main__":
    main()
