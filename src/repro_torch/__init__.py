"""PyTorch/CUDA port of the serverless keep-alive policy simulator.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` or ``repro``. The main path is the paper's own
experiment (§5.1): a keep-alive policy grid replayed over an invocation
trace, with the hybrid histogram step running as a hand-written CUDA kernel
on the card (:mod:`repro_torch.kernels.histogram`).

    from repro_torch.core.experiment import HybridSpec, run
    from repro_torch.core.workload_spec import WorkloadSpec
    res = run(WorkloadSpec.uniform(1000, days=14.0), HybridSpec(use_arima=False))
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # Lazy, so that ``repro_torch.analysis`` (standard library only) runs
    # where torch is not installed.
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
