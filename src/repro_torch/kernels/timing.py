"""Timing of the kernels on the card: per call (CUDA events around calls
run back to back, the wrapper's host work included), per call on the
device alone (CUDA events around the replay of a CUDA graph of the
calls) and per CUDA function (``torch.profiler`` device time).
``chip_smoke.py`` times the kernels with :func:`launch_ms`, the
attention, decode and SSD kernels and the calls they are compared with
also with :func:`graph_ms`, and splits the SSD scan by kernel with
:func:`pass_ms`; it makes the SSD inputs with :func:`ssd_inputs`.
"""
from __future__ import annotations

import re


def ssd_inputs(b, l, h, p, n, dtype, device, seed, model_like, groups=None):
    """x, B and C as views into one [b, l, h*p + 2 G n] tensor in ``dtype``,
    as the model hands them over (its conv output), dt [b, l, h] and A [h]
    f32. B and C are [b, l, n] (G = 1) where ``groups`` is None, else [b,
    l, groups, n]. ``model_like``: dt = softplus(normal - 1) and A =
    -linspace(1, 16, h), as the model's init gives; else the reference
    tests' dt = 0.1 |normal| and A = -|normal|, whose slow decays keep the
    carried state large."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    di, gn = h * p, (groups or 1) * n
    xbc = torch.randn(b, l, di + 2 * gn, generator=g, device=device).to(dtype)
    x = xbc[..., :di].reshape(b, l, h, p)
    B, C = xbc[..., di:di + gn], xbc[..., di + gn:]
    if groups is not None:
        B, C = B.unflatten(-1, (groups, n)), C.unflatten(-1, (groups, n))
    if model_like:
        dt = F.softplus(torch.randn(b, l, h, generator=g, device=device) - 1)
        A = -torch.linspace(1.0, 16.0, h, device=device)
    else:
        dt = 0.1 * torch.randn(b, l, h, generator=g, device=device).abs()
        A = -torch.randn(h, generator=g, device=device).abs()
    return x, dt, A, B, C


def launch_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so that the
    host's work for each call (argument checks, allocation, the launch) is
    left out. ``fn`` must launch its work on the current stream."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / (replays * reps)
    del graph
    return ms


def pass_ms(fn, reps: int = 5, pattern: str = r"ssd_\w+") -> dict:
    """Device ms per launch of each kernel ``fn`` launches whose CUDA
    function name holds a match of ``pattern`` (the SSD kernels'
    ``ssd_<pass>`` by default), keyed by that match, from
    ``torch.profiler`` over ``reps`` calls; each kernel's total over the
    launches the profiler recorded, which after a long process can be
    fewer than ``reps``. Empty where the profiler records no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = {}, {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if e.device_type != DeviceType.CUDA or not m:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        us[m.group(0)] = us.get(m.group(0), 0.0) + t
        count[m.group(0)] = count.get(m.group(0), 0) + e.count
    return {k: us[k] / 1e3 / count[k] for k in us if count[k]}
