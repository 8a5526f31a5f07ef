"""One run of one cell: set-up, the measured window, and the checks.

Set-up draws each endpoint's weights (:mod:`portbench.weights`) and hands
them to the program as its host image, serves one warm-up request an
endpoint through the whole loop (the first loads and the decode graphs'
captures), and runs one prefill at every prompt length the mix sends.

The window is a closed loop, one caller serving one card, as a serverless
invoker does. For each request in arrival order, at its virtual arrival
time ``now``:

  1. ``pool.tick(now)``, then mirror;
  2. ``pool.on_request(app, now)``, then mirror;
  3. ``engine.generate(app, prompt, new, max_len)``;
  4. ``pool.on_request_end(app, now)``, then mirror;

where mirroring loads every endpoint the pool holds resident and the
engine does not (``engine.load``) and unloads every one the engine holds
and the pool does not. A request's latency is the load it waited for (when
the pool found it cold) plus ``generate``'s seconds. The window ends when
``seconds`` of wall time have passed; the request under way finishes.

The checks, after the window and with the program's state freed: the
served tokens of a sample of requests (the longest among them) against the
plain reference's logits, and every verdict, load and unload against the
plain replay of the keep-alive rules (:mod:`portbench.check`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import resource
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, traffic as traffic_mod, weights
from .trace import Trace, busy_s, device_ops, from_profiler, idle_gaps, \
    window_s

__all__ = ["ROOT", "load_spec", "Cell", "run_cell"]

ROOT = Path(__file__).resolve().parent
#: Seconds of the window the profiler records in a ``--trace 1`` run.
TRACE_SECONDS = 10.0
#: Least completed requests for a 95th percentile (ten lie beyond it).
P95_MIN_REQUESTS = 200


def load_spec(root: Path = ROOT.parent) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` and the files it names."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.config = json.loads(
            (root / "configs" / f"{self.entry['config']}.json").read_text())
        self.traffic = json.loads(
            (root / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.root = root
        self.reference = _module(root / "reference" /
                                 f"{self.config['reference']}.py")

        def mine(metric):
            return "workloads" not in metric or name in metric["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, metric: str):
        return _module(self.root / "metrics" / f"{metric}.py").read


def _module(path: Path):
    """The module of the file ``path`` (a metric's reader, a reference),
    loaded once."""
    name = "portbench._by_path." + "_".join(
        path.with_suffix("").parts[-2:]).replace(".", "_")
    mod = sys.modules.get(name)
    if mod is None or getattr(mod, "__file__", None) != str(path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _policy_spec(p: dict):
    from repro_torch.core.experiment import FixedSpec, HybridSpec
    if p["kind"] == "fixed":
        return FixedSpec(keep_alive=p["keep_alive_minutes"])
    if p["kind"] == "hybrid":
        return HybridSpec(**{k: v for k, v in p.items() if k != "kind"})
    raise ValueError(f"unknown policy {p['kind']!r}")


class Invoker:
    """The closed loop's serving of one request, with the benchmark's own
    spans (``portbench.*`` ranges in a traced run) around the pool's calls,
    the engine's loads and ``generate``."""

    def __init__(self, engine, pool, apps: List[str], max_len: int,
                 traced: bool):
        self.engine, self.pool, self.apps = engine, pool, apps
        self.max_len = max_len
        self.traced = traced
        self.loads: List[dict] = []
        self.actions: List[tuple] = []      # (request, step, endpoint, verb)
        self.host_bytes: Dict[str, int] = {}

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")

    def mirror(self, i: int, step: str) -> float:
        """Mirror the pool onto the engine; returns the seconds the engine's
        loads and unloads took (the pool's own time leaves them out)."""
        spent = 0.0
        for e, app in enumerate(self.apps):
            st = self.pool.state.get(app)
            resident = st is not None and st.loaded
            if resident and not self.engine.is_loaded(app):
                first = not any(ld["app"] == app for ld in self.loads)
                with self.span("load"):
                    s = self.engine.load(app)
                spent += s
                self.loads.append(dict(app=app, request=i, step=step,
                                       seconds=s, first=first,
                                       bytes=self.host_bytes[app]))
                self.actions.append((i, step, e, "load"))
            elif not resident and self.engine.is_loaded(app):
                t0 = time.perf_counter()
                with self.span("unload"):
                    self.engine.unload(app)
                spent += time.perf_counter() - t0
                self.actions.append((i, step, e, "unload"))
        return spent

    def serve(self, req, tokens) -> dict:
        app, now = self.apps[req.app], req.arrival_s
        n_loads = len(self.loads)
        t0 = time.perf_counter()
        with self.span("pool"):
            self.pool.tick(now)
        spent = self.mirror(req.index, "tick")
        with self.span("pool"):
            cold, _ = self.pool.on_request(app, now)
        spent += self.mirror(req.index, "request")
        pool_s = time.perf_counter() - t0 - spent
        load_s = sum(ld["seconds"] for ld in self.loads[n_loads:]
                     if ld["app"] == app and ld["step"] == "request")
        rec = dict(index=req.index, app=req.app, cold=cold, prompt=req.prompt,
                   new=req.new, load_s=load_s, error=None, start=t0)
        try:
            with self.span("generate"):
                out, gen_s = self.engine.generate(
                    app, tokens, max_new=req.new, max_len=self.max_len)
            rec.update(gen_s=gen_s, latency_s=load_s + gen_s, out=out,
                       **self.engine.last_times)
        except Exception as exc:           # counted as failed, run goes on
            rec.update(error=f"{type(exc).__name__}: {exc}")
        t1 = time.perf_counter()
        with self.span("pool"):
            self.pool.on_request_end(app, now)
        spent = self.mirror(req.index, "end")
        done = time.perf_counter()
        rec.update(pool_s=pool_s + (done - t1 - spent), done=done)
        return rec


def _percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` percentile."""
    v = sorted(values)
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def _tokens_per_s(done: List[dict], t_start: float,
                  seconds: Optional[float]) -> float:
    """The work of the window over its seconds: each completed request's
    prompt and new tokens, the one under way when the window closed counted
    for the share of its time that fell inside it. (Counted whole, a cold
    request, about 2% of a 45-s window, moved the rate by 2-3% as the window
    happened to end before or after it.) Without ``seconds`` the window is
    its requests'."""
    end = max(r["done"] for r in done)
    if seconds is not None:
        end = min(end, t_start + seconds)
    work = 0.0
    for r in done:
        inside = min(max((end - r["start"]) / (r["done"] - r["start"]), 0.0),
                     1.0)
        work += (r["prompt"] + r["new"]) * inside
    return work / (end - t_start)


def _host_memory(host_bytes: Dict[str, int]) -> str:
    """The host's memory beside what the endpoints' images hold of it: the
    machine's total, this process's peak resident set, and the images'
    bytes (pinned on a card)."""
    total = "not read"
    with contextlib.suppress(OSError, ValueError, IndexError):
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("MemTotal:"):
                total = f"{int(line.split()[1]) * 1024 / 1e9:.1f} GB"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return (f"host memory: {total} in all, this process's peak resident "
            f"{peak:.1f} GB, endpoint images "
            + ", ".join(f"{b / 1e9:.1f}" for b in host_bytes.values())
            + " GB")


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device, t0: float, control: bool = False,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             trace_seconds: float = TRACE_SECONDS,
             requests: Optional[int] = None) -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``) and
    ``report``, the lines that go to standard error. ``config`` and
    ``traffic`` replace the cell's files (the CPU tests' small sizes);
    ``requests``, where given, makes the window serve that many requests
    whatever their time (the CPU tests' fixed work)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import ModelEndpoint, Registry, ServeEngine, \
        WarmPool
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.serving.engine import _to_host
    counted = {"flash_attention": flash_attention,
               "decode_attention": decode_attention}
    launches = lambda: {k: mod.LAUNCHES for k, mod in counted.items()}

    cell = Cell(bench, workload)
    if config is not None:
        cell.config = config
    if traffic is not None:
        cell.traffic = traffic
    cfg_file, mix = cell.config, cell.traffic
    m = cfg_file["model"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    layout = cell.reference.param_layout(m)
    image_bytes = 2 * sum(math.prod(s) for _, items in layout
                          for _, s, _ in items)
    E = mix["endpoints"]
    apps = [f"{cfg_file['name']}-{e}" for e in range(E)]
    reg = Registry()
    mcfg = ModelConfig(**m)
    for e, app in enumerate(apps):
        reg.register(ModelEndpoint(app, mcfg, seed=e,
                                   weight_bytes=image_bytes))
    engine = ServeEngine(reg, device=dev)
    budget = image_bytes * mix["budget_images"]
    pool = WarmPool(reg, _policy_spec(mix["policy"]), budget_bytes=budget)
    inv = Invoker(engine, pool, apps, mix["max_len"], traced=False)

    # -- set-up: weights, warm-up requests, every prompt length -------------
    stages = {"imports": time.perf_counter() - t0}
    t_stage = time.perf_counter()
    for e, app in enumerate(apps):
        params = weights.program_params(cfg_file, layout, seed, e, dev)
        engine._weights[app] = _to_host(params, pin=cuda)
        inv.host_bytes[app] = sum(p.numel() * p.element_size()
                                  for p in engine._weights[app].parameters())
        del params
        if cuda:
            torch.cuda.empty_cache()
    stages["weights"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    served = []                                    # (request, record)
    warm = traffic_mod.warmups(mix, cfg_file, seed)
    for req in warm:
        rec = inv.serve(req, traffic_mod.prompt_tokens(req, m["vocab"], dev))
        if rec["error"]:
            raise RuntimeError(f"warm-up request failed: {rec['error']}")
        served.append((req, rec))
    stages["warm-ups"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    for S in sorted({p for p, _ in traffic_mod.pairs(mix, cfg_file)}):
        probe = traffic_mod.Request(-100, 0, 0.0, S, 1, seed)
        engine.generate(apps[0], traffic_mod.prompt_tokens(probe, m["vocab"],
                                                           dev),
                        max_new=1, max_len=mix["max_len"])
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    stages["prompt lengths"] = time.perf_counter() - t_stage
    setup_s = time.perf_counter() - t0

    # -- the window ------------------------------------------------------------
    prof = span = None
    window: List[dict] = []
    n_traced = 0
    stream = traffic_mod.requests(mix, cfg_file, seed)
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        inv.traced = True
        span = torch.profiler.record_function("portbench.window")
        span.__enter__()
    t_start = time.perf_counter()               # after the profiler's start
    at_start = launches()
    since_start = lambda: {k: v - at_start[k] for k, v in launches().items()}
    traced_launches = {}

    def stop_trace():
        nonlocal span, n_traced, traced_launches
        sync()
        span.__exit__(None, None, None)
        prof.stop()
        span, inv.traced, n_traced = None, False, len(window)
        traced_launches = since_start()

    for req in stream:
        now = time.perf_counter() - t_start
        if (len(window) >= requests) if requests else now >= seconds:
            break
        if span is not None and now >= trace_seconds:
            stop_trace()
        tokens = traffic_mod.prompt_tokens(req, m["vocab"], dev)
        rec = inv.serve(req, tokens)
        served.append((req, rec))
        window.append(rec)
    if span is not None:
        stop_trace()
    sync()
    window_launches = since_start()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for _, rec in served:
        if rec.get("out") is not None:
            rec["out"] = rec["out"][0].tolist()
    t_trace = from_profiler(prof, "portbench.window") if prof else None
    del prof

    stats = dataclasses.asdict(pool.stats)

    # -- free the program's state, then check ------------------------------
    for app in apps:
        engine.unload(app)
    engine._weights.clear()
    del engine, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        host_empty = getattr(torch._C, "_host_emptyCache", None)
        if host_empty is not None:
            host_empty()

    done = [r for r in window if not r["error"]]
    failed = len(window) - len(done)
    checks, readings = check.run_checks(cell, seed, served, inv.actions,
                                        image_bytes, budget, dev,
                                        control=control)
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics: Dict[str, dict] = {}
    result = dict(correct=correct, attempted=len(window), failed=failed)
    if not trace:
        lat = [r["latency_s"] for r in done]
        values = {"setup_s": setup_s}
        if done:
            values["request_p50_s"] = statistics.median(lat)
            values["tokens_per_s"] = _tokens_per_s(
                done, t_start, None if requests else seconds)
            if len(done) >= P95_MIN_REQUESTS:
                values["request_p95_s"] = _percentile(lat, 95)
        for mt in cell.end_to_end:
            if mt["name"] in values:
                metrics[mt["name"]] = {"value": values[mt["name"]],
                                       "unit": mt["unit"]}
    else:
        run = RunRecord(window, n_traced, inv.loads, t_trace, m, dev,
                        traced_launches)
        for mt in cell.per_layer:
            v = cell.reader(mt["name"])(run)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    result["metrics"] = metrics
    result["device"] = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=1, memory_peak_bytes=peak)
    if t_trace is not None:
        result["device"].update(busy_s=busy_s(t_trace),
                                window_s=window_s(t_trace))
        result["breakdown"] = {"device_ops": device_ops(t_trace),
                               "idle_gaps": idle_gaps(t_trace)}
    result["readings"] = readings
    result["checks"] = checks
    pool_stats = dict(cold=sum(r["cold"] for r in window),
                      warm=sum(not r["cold"] for r in window),
                      loads=sum(ld["request"] >= 0 for ld in inv.loads))
    result["report"] = [
        f"cell {workload} seed {seed}: {len(window)} requests "
        f"({pool_stats['cold']} cold, {pool_stats['warm']} warm, "
        f"{pool_stats['loads']} loads in the window), {failed} failed, "
        f"setup {setup_s:.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()) + ")",
        f"pool (whole run): {json.dumps(stats)}",
        f"kernel launches in the window: {json.dumps(window_launches)}",
        _host_memory(inv.host_bytes),
        f"readings: {json.dumps(readings)}"] + [
        f"{r['index']}: {r['error']}" for r in window if r["error"]][:5] + [
        f"check {name}: {c['value']} (limit {c['limit']})"
        for name, c in checks.items()]
    return result


class RunRecord:
    """What a per-layer metric's reader reads: the window's completed
    requests, split into the profiled ones (``traced``, the first
    ``n_traced`` of the window) and the rest (``untraced``, or all of them
    where every request was profiled), the loads in the window, the trace
    and the program's launch counters over it, the configuration's
    ``model`` group and the card's peaks."""

    def __init__(self, window, n_traced: int, loads, trace: Optional[Trace],
                 model: dict, device, launches: Optional[dict] = None):
        ok = lambda rs: [r for r in rs if not r["error"]]
        self.requests = ok(window)
        self.traced = ok(window[:n_traced])
        self.untraced = ok(window[n_traced:]) or self.requests
        self.loads = [ld for ld in loads if ld["request"] >= 0]
        self.trace = trace
        #: the program's kernel launch counters over the profiled requests
        self.launches = launches or {}
        self.model = model
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        from .counts import peaks
        self.peaks = peaks(name)
