"""Meshes of the port (the port of ``repro/launch/mesh.py``), defined as
FUNCTIONS: importing this module touches no process group.

The reference is one process over many devices; PyTorch runs one process
per device, so a mesh here is a ``torch.distributed`` ``DeviceMesh`` over
the ranks of the current process group: NCCL ranks on cards, gloo ranks on
the CPU, or the fake process group of the dry-run
(:mod:`repro_torch.launch.dryrun`), whose 256 or 512 ranks exist only as
shapes. Single pod = 16 x 16 = 256 devices (``("data", "model")``);
multi-pod = 2 pods = 512 devices with a leading ``"pod"`` axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "HBM_BYTES",
           "make_production_mesh", "make_host_mesh", "make_app_mesh",
           "axis_sizes", "data_axes", "model_axis", "mesh_device_type"]

# Hardware constants of one card: NVIDIA H100 80GB HBM3, 700 W (the SXM
# part, as nvidia-smi --query-gpu=name,power.limit names it), NVIDIA's
# published dense rates.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12                # bytes/s of HBM3
HBM_BYTES = 80e9                # bytes of HBM
NVLINK_BW = 450e9               # bytes/s each way over NVLink 4 (900 GB/s both)


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL process group, else ``"cpu"`` (gloo, and
    the dry-run's fake group)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world(n: int, what: str) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"{what} needs a process group of {n} ranks but there are "
            f"{world}; the dry-run (python -m repro_torch.launch.dryrun) "
            f"starts the fake process group of that size "
            f"(torch.testing._internal.distributed.fake_pg.FakeStore) before "
            f"it builds the mesh")
    return world


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``, over the current world (which
    must have exactly 256 or 512 ranks)."""
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    _world(n, f"mesh {shape}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1) -> DeviceMesh:
    """``(world // mp, mp)`` ``("data", "model")`` over every rank of the
    current group (tests, examples): gloo ranks on the CPU, NCCL on cards.
    ``mp = min(model_parallel, world)`` must divide the world."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    mp = max(1, min(int(model_parallel), world))
    if world % mp:
        raise ValueError(f"model_parallel={mp} does not divide the world "
                         f"of {world} ranks")
    return init_device_mesh(mesh_device_type(), (world // mp, mp),
                            mesh_dim_names=("data", "model"))


def make_app_mesh(n_devices: Optional[int] = None, device="cuda"):
    """The simulator's app-axis mesh: the ordered devices the app rows
    split across (:func:`repro_torch.distributed.scaleout.mesh_for`);
    ``None`` takes every card (one shard on the CPU)."""
    from ..distributed.scaleout import mesh_for
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.device(device).type == "cuda" else 1)
    return mesh_for(n_devices, device)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of anything with
    ``axis_names`` and a ``shape`` mapping (the reference's ``Mesh``, or a
    stand-in: spec derivation needs no process group)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {a: int(mesh.size(i)) for i, a in enumerate(names)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def model_axis(mesh) -> str:
    return "model"
