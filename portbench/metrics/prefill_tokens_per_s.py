"""Prompt tokens a second of prefill: the window's prompt tokens divided by
the seconds of ``engine.last_times["prefill_s"]`` (layer: prefill)."""


def read(run):
    reqs = [r for r in run.untraced if r.get("prefill_s", 0) > 0]
    if not reqs:
        return None
    return sum(r["prompt"] for r in reqs) / sum(r["prefill_s"] for r in reqs)
