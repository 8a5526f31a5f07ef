"""Median seconds of the executable cache's capture of a decode graph
(``engine.last_times["capture_s"]``) over the window's requests that
captured (layer: executable cache)."""
import statistics


def read(run):
    caps = [r["capture_s"] for r in run.untraced if r.get("capture_s", 0) > 0]
    return statistics.median(caps) if caps else None
