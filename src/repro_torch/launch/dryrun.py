"""Multi-pod dry-run: run every (architecture x input shape) step once on
the production meshes with no memory behind any tensor (the port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 256 or 512 forced host
devices and reads XLA's memory and cost analyses. The port runs one
process per device, so the dry-run is one process standing in for rank 0
of a world of 256 (16 x 16 ``("data", "model")``) or 512 (2 x 16 x 16, with
``"pod"``) ranks: :func:`main` starts the fake process group
(``torch.testing._internal.distributed.fake_pg``) of that size — in main,
not at import — and each cell runs under ``FakeTensorMode``: the model is
built on the meta device, its parameters, optimizer state and inputs are
DTensors placed by ``distributed.sharding``'s plan, and the train, prefill
or serve step of ``launch.steps`` runs once, eagerly, every layer (so no
depth extrapolation is needed: the reference extrapolates because XLA's
cost analysis counts a scanned layer body once).

Per device (rank 0's shards), each cell records:
  * ``argument_size``: the bytes of the step's arguments' local shards
    (state or parameters, batch, cache), exact from the specs;
  * ``peak_bytes``: arguments plus the largest sum of live storages the
    step allocates, from this module's own fake-allocation counter (every
    local storage an op creates, freed when Python drops it); an estimate
    of the port's eager peak, not a compiler's;
  * ``flops``: the local (per-shard) products' FLOPs, with
    ``torch.utils.flop_counter``'s formulas, counted on the local tensors
    DTensor computes on (``FlopCounterMode`` over DTensors counts the global
    op: the dry-run's counter is the fake mode itself, which sees only local
    tensors, and it skips the ops of DTensor's global-shape inference);
  * collective bytes and counts by kind, from the functional and c10d
    collectives the ranks issue (output bytes, as the reference sums the
    HLO collectives' output shapes); ``CommDebugMode`` counts the same
    collectives (the counts are cross-checked);
  * the seconds the cell took on the host.

The reference's HLO-text parsers (``collective_bytes``, ``cpu_upcast_bytes``)
have no HLO to read here: the tally above is their counterpart, and the CPU
upcast correction has no meaning (the fake tensors keep bf16 as bf16).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out F]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import flop_registry

from .. import configs
from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..distributed import ctx
from ..distributed import sharding as shd
from ..interop import _param_module
from ..launch import mesh as mesh_lib
from ..launch.steps import (make_prefill_step, make_serve_step,
                            make_train_step, place_batch)
from ..models import build
from ..models.model import TensorSpec
from ..training import optimizer as opt

__all__ = ["COLLECTIVES", "fake_world", "lower_cell", "main"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name fragment -> kind (functional collectives, then c10d's)
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("reducescatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("send", "collective-permute"), ("recv", "collective-permute"))


def fake_world(world: int) -> None:
    """Start the fake process group of ``world`` ranks as rank 0 (every
    collective returns at once; no other rank exists)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class _Counting(FakeTensorMode):
    """The fake mode of a cell, counting what rank 0 computes: ops on the
    local (fake) tensors reach it, DTensor-level ops do not (DTensor
    dispatches them to their local ops). DTensor's global-shape inference
    may also run its ops under this mode; those are not counted."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.counting = False
        self.flops = 0
        self.coll: Dict[str, Dict[str, float]] = {
            k: {"bytes": 0.0, "count": 0} for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._depth = 0
        self._seen = weakref.WeakSet()

    @staticmethod
    def _inferring() -> bool:
        """Whether DTensor's global-shape inference is on the stack (its
        ``_propagate_tensor_meta*`` runs the global op on fake tensors; by
        name, which PyTorch releases share)."""
        f = sys._getframe(2)
        while f is not None:
            if "propagate_tensor_meta" in f.f_code.co_name:
                return True
            f = f.f_back
        return False

    def start(self, argument_bytes: int) -> None:
        self.counting = True
        self.live = self.peak = int(argument_bytes)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is NotImplemented or self._depth or self._inferring():
            return out
        if not self.counting:
            # the arguments' storages, made before the step: seen, so that
            # a view or detach of one inside the step is not counted again
            for x in torch.utils._pytree.tree_leaves(out):
                if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                    self._seen.add(x.untyped_storage())
            return out
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = str(func)
        if ("c10d" in name and "wait" not in name
                and "barrier" not in name):
            kind = next((k for frag, k in _KINDS if frag in name), None)
            if kind is not None:
                res = out if "_functional" in name else args[0]
                self.coll[kind]["count"] += 1
                self.coll[kind]["bytes"] += sum(
                    x.numel() * x.element_size() for x in
                    torch.utils._pytree.tree_leaves(res)
                    if isinstance(x, torch.Tensor))
        for x in torch.utils._pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
                self._alloc(x)
        return out


def _local_bytes(tree) -> int:
    """Bytes of every DTensor's local shard (and plain tensor) in a tree
    (dicts, lists, modules)."""
    if isinstance(tree, nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _fake_params(model, mesh, specs, dtype) -> nn.Module:
    """The model's parameter module (built on the meta device) with every
    parameter a fake DTensor of ``dtype`` in its spec's placements."""
    with torch.device("meta"):
        params = _param_module(model.cfg)(model.cfg)
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        d = distribute_tensor(torch.empty(p.shape, dtype=dtype), mesh,
                              shd.placements(specs[name], mesh),
                              src_data_rank=None)
        setattr(mod, leaf, nn.Parameter(d, requires_grad=False))
    return params


def _fake_tree(tree, specs, mesh):
    """A tree of :class:`TensorSpec` (and host ints) as fake DTensors of
    zeros placed by the matching tree of specs."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fake_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, TensorSpec):
        return distribute_tensor(torch.zeros(tree.shape, dtype=tree.dtype),
                                 mesh, shd.placements(specs, mesh),
                                 src_data_rank=None)
    return tree


def _mesh_str(mesh) -> str:
    sizes = mesh_lib.axis_sizes(mesh)
    return "x".join(str(sizes[a]) for a in mesh.mesh_dim_names)


def lower_cell(arch_id: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Run one (arch, shape) cell's step once on ``mesh`` (a
    ``DeviceMesh`` over the fake process group) and return its per-device
    record. ``cfg`` and ``shape`` override the registry's config of
    ``arch_id`` and ``SHAPES[shape_name]`` (reduced cells)."""
    cfg = cfg or configs.get(arch_id)
    shape = shape or SHAPES[shape_name]
    model = build(cfg)
    mode = _Counting()
    t0 = time.time()
    comm = CommDebugMode()
    with mode, ctx.use_mesh(mesh), implicit_replication():
        with torch.device("meta"):
            pmeta = _param_module(cfg)(cfg)
        inputs = model.input_specs(shape)
        bspecs = shd.batch_specs(cfg, inputs, mesh)
        if shape.kind == "train":
            ospecs = shd.opt_specs(pmeta, mesh, cfg)
            params = _fake_params(model, mesh, ospecs, torch.float32)
            zeros = lambda: {n: torch.zeros_like(p)
                             for n, p in params.named_parameters()}
            state = opt.TrainState(step=0, params=params, m=zeros(),
                                   v=zeros())
            batch = place_batch(_fake_tree(inputs, bspecs, mesh), mesh,
                                cfg)
            step = make_train_step(model, opt.OptConfig(),
                                   grad_shardings=shd.named(ospecs, mesh))
            args = (state.params, state.m, state.v, batch)
            run = lambda: step(state, batch)
        else:
            pspecs = shd.param_specs(pmeta, mesh, cfg)
            params = _fake_params(model, mesh, pspecs, torch.bfloat16)
            batch = _fake_tree(inputs, bspecs, mesh)
            if shape.kind == "prefill":
                step = make_prefill_step(model, max_len=shape.seq_len)
                run = lambda: step(params, batch)
            else:
                step = make_serve_step(model)
                run = lambda: step(params, batch["token"],
                                   batch["cache"])
            args = (params, batch)
        arg_bytes = _local_bytes(args)
        mode.start(arg_bytes)
        with comm:
            run()
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    coll = {k: dict(v) for k, v in mode.coll.items()}
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": _mesh_str(mesh),
        "n_devices": int(mesh.size()),
        "kind": shape.kind,
        "flops": float(mode.flops),
        "collective_bytes": float(sum(v["bytes"] for v in coll.values())),
        "collectives": coll,
        "comm_debug_counts": counts,
        "argument_size": float(arg_bytes),
        "peak_bytes": float(mode.peak),
        "peak_share_of_hbm": mode.peak / mesh_lib.HBM_BYTES,
        "seconds": round(time.time() - t0, 3),
        "n_params": model.n_params(),
        "n_params_active": model.n_params(active_only=True),
        "host": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 (512-device) mesh")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--optimized", action="store_true",
                    help="chunked cross-entropy for train cells and "
                         "distributed flash-decode for decode cells")
    args = ap.parse_args(argv)
    if args.optimized:
        from ..distributed import dist_decode
        dist_decode.ENABLED = True
        configs.ARCHS.update({k: v.with_(chunked_xent=True)
                              for k, v in configs.ARCHS.items()})
    if args.all:
        cells = [(a, s) for a in configs.ARCHS for s in SHAPES
                 if s != "long_500k" or a in configs.SUBQUADRATIC]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    meshes = []
    if not args.multi_pod or args.single_pod_only:
        meshes.append(("single-pod", False))
    if args.multi_pod:
        meshes.append(("multi-pod", True))

    done = set()
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done.add((r.get("mesh_name"), r["arch"], r["shape"]))

    failures = 0
    for mesh_name, multi in meshes:
        fake_world(512 if multi else 256)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi)
        for arch_id, shape_name in cells:
            tag = f"{mesh_name}:{arch_id}:{shape_name}"
            if (mesh_name, arch_id, shape_name) in done:
                print(f"SKIP {tag:55s} (already in {args.out})", flush=True)
                continue
            try:
                res = lower_cell(arch_id, shape_name, mesh)
            except Exception as e:  # noqa: BLE001 — report, go on, fail
                failures += 1
                print(f"FAIL {tag:55s} {type(e).__name__}: "
                      f"{str(e)[:400]}", flush=True)
                continue
            res["mesh_name"] = mesh_name
            print(f"OK   {tag:55s} flops/dev={res['flops']:.3e} "
                  f"coll/dev={res['collective_bytes']:.3e}B "
                  f"args/dev={res['argument_size'] / 2**30:.2f}GiB "
                  f"peak/dev={res['peak_bytes'] / 2**30:.2f}GiB "
                  f"({res['peak_share_of_hbm']:.0%} of the card) "
                  f"host_s={res['seconds']}", flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
