"""The multi-rank half of ``tests/test_torch_distributed.py``: ``python
tests/torch_dist_job.py WORKDIR WORLD`` spawns WORLD gloo ranks on the CPU
(``file://`` rendezvous in WORKDIR, so parallel test workers never share a
port), each of which runs the port's multi-device layers on the inputs the
test wrote to ``WORKDIR/inputs.pkl`` and writes its results (numpy only) to
``WORKDIR/out_<rank>.pkl``. It imports no jax and nothing of ``repro``:
the reference side of each comparison runs in the test's own process."""
import os
import pickle
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _np(t):
    from repro_torch.distributed.sharding import full
    return full(t.detach()).float().cpu().numpy()


class _Sequence:
    """Records, in order, each whole-leaf gather (``full_tensor``), ``.npy``
    write and read, and placement (``sharding.shard``) made inside the
    ``with`` block: what a rank held at once during a save or restore."""

    def __init__(self):
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed import sharding as shd
        self.events = []
        self._sites = [(DTensor, "full_tensor", "gather"),
                       (np, "save", "write"), (np, "load", "read"),
                       (shd, "shard", "place")]

    def __enter__(self):
        self._saved = [getattr(o, a) for o, a, _ in self._sites]
        for (owner, attr, kind), fn in zip(self._sites, self._saved):
            def logged(*a, _fn=fn, _kind=kind, **kw):
                self.events.append(_kind)
                return _fn(*a, **kw)
            setattr(owner, attr, logged)
        return self

    def __exit__(self, *exc):
        for (owner, attr, _), fn in zip(self._sites, self._saved):
            setattr(owner, attr, fn)


def _zero_and_elastic(inp, workdir, out):
    """ZeRO train steps on a (2, 2) mesh for each architecture of
    ``zero_archs``; then the first one's state saved and restored onto
    (4, 1)."""
    from repro_torch.configs import get, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.runtime import elastic
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt

    mesh = make_host_mesh(model_parallel=2)               # (2, 2)
    batch = {k: torch.from_numpy(v) for k, v in inp["zero_batch"].items()}
    for arch in inp["zero_archs"]:
        cfg = reduced(get(arch))
        model = Model(cfg)
        state = opt.init_state(model.init(0, device="cpu"))
        ospecs = shd.opt_specs(state.params, mesh, cfg)
        state = shd.distribute_state(state, mesh, ospecs)
        step = steps.make_train_step(model, opt.OptConfig(**inp["opt"]),
                                     grad_shardings=shd.named(ospecs, mesh))
        losses = []
        for _ in range(3):
            state, met = step(state, batch)
            losses.append(float(met["loss"].full_tensor()))
        out[arch] = {
            "losses": losses,
            "masters": {n: _np(p) for n, p in
                        state.params.named_parameters()},
            "m": {n: _np(t) for n, t in state.m.items()},
            "placements": {n: str(p.placements) for n, p in
                           state.params.named_parameters()},
            "local": {n: tuple(p.to_local().shape) for n, p in
                      state.params.named_parameters()}}
        if arch == inp["zero_archs"][0]:
            first, first_model, first_cfg = state, model, cfg

    with _Sequence() as saving:
        ckpt.save(os.path.join(workdir, "ckpt"), 3, first)
    mesh41 = make_host_mesh(model_parallel=1)              # (4, 1)
    template = opt.init_state(first_model.init(1, device="cpu"))
    with _Sequence() as restoring:
        restored = elastic.resharded_restore(os.path.join(workdir, "ckpt"),
                                             3, template, mesh41, first_cfg)
    out["save_events"], out["restore_events"] = (saving.events,
                                                 restoring.events)
    out["n_leaves"] = 3 * len(list(first.params.parameters()))
    out["elastic_ok"] = elastic.verify_roundtrip(first, restored, atol=0.0)
    out["elastic_equal"] = all(
        torch.equal(shd.full(a.detach()), shd.full(b.detach()))
        for (_, a), (_, b) in zip(first.params.named_parameters(),
                                  restored.params.named_parameters()))
    out["elastic_step"] = restored.step
    out["elastic_local"] = {n: tuple(p.to_local().shape) for n, p in
                            restored.params.named_parameters()}


def _dist_decode(inp, out):
    """Distributed flash-decode over 4 model ranks, (1, 4) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import interop
    from repro_torch.configs import get, reduced
    from repro_torch.distributed import ctx, dist_decode
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.model import Model

    cfg = reduced(get("qwen2-72b")).with_(remat=False)
    model = Model(cfg)
    params = interop.model_params_from_numpy(cfg, inp["dd_params"],
                                             device="cpu")
    toks = torch.from_numpy(inp["dd_tokens"]).long()
    with torch.no_grad():
        _, cache = model.prefill(params, toks, max_len=64)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    dist_decode.ENABLED = True
    try:
        specs = shd.cache_specs_tree(cfg, cache, mesh)
        for key in ("k", "v"):
            cache[key] = [distribute_tensor(t, mesh,
                                            shd.placements(s, mesh),
                                            src_data_rank=None)
                          for t, s in zip(cache[key], specs[key])]
        out["dd_cache_placement"] = str(cache["k"][0].placements)
        logits = []
        with torch.no_grad(), ctx.use_mesh(mesh), implicit_replication():
            tok = toks[:, 0]
            for i in range(4):
                lg, cache = model.decode_step(params, tok, cache)
                logits.append(_np(lg))
                if i == 0:
                    out["dd_cache_k"] = [_np(k) for k in cache["k"]]
                tok = torch.from_numpy(inp["dd_tokens"][:, i + 1]).long()
        out["dd_logits"] = logits
    finally:
        dist_decode.ENABLED = False


def _pipeline(inp, out):
    """GPipe over 2 pod stages, 4 microbatches, (2, 2, 1) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import interop
    from repro_torch.configs import get, reduced
    from repro_torch.distributed import ctx
    from repro_torch.models.model import Model

    cfg = reduced(get("smollm-135m")).with_(remat=False, n_layers=2)
    model = Model(cfg.with_(pipeline_stages=2, pipeline_microbatches=4))
    params = interop.model_params_from_numpy(cfg, inp["pp_params"],
                                             device="cpu")
    params.requires_grad_(True)
    toks = torch.from_numpy(inp["pp_tokens"]).long()
    mesh = init_device_mesh("cpu", (2, 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    with ctx.use_mesh(mesh):
        logits = model.forward(params, toks)
        loss = (logits.float() ** 2).mean()
        loss.backward()
    out["pp_stage"] = mesh.get_local_rank("pod")
    out["pp_logits"] = logits.detach().numpy()
    out["pp_grads"] = {n: p.grad.numpy() for n, p in params.named_parameters()
                       if p.grad is not None}


def _rank(rank, world, workdir):
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdzv",
                            rank=rank, world_size=world)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    try:
        _zero_and_elastic(inp, workdir, out)
        _dist_decode(inp, out)
        _pipeline(inp, out)
    finally:
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    workdir, world = sys.argv[1], int(sys.argv[2])
    mp.start_processes(_rank, args=(world, workdir), nprocs=world,
                       start_method="spawn")
