"""The port's multi-device layers on gloo ranks on the CPU, each held
against a single-device run: the reference's sequential ``forward`` and
``jax.grad`` for the pipeline, the reference's ``decode_step`` for the
distributed decode (as ``tests/test_pipeline_dist.py`` does), the port's
own unsharded step for the ZeRO step, and the saved state for the elastic
restore.

One job of 4 ranks (``tests/torch_dist_job.py``, spawned once for the
module, ``file://`` rendezvous in ``tmp_path``) runs all of them; the
reference side runs here, in the test's process, on one device.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get, reduced
from repro_torch.distributed import ctx
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
OPT = {"warmup_steps": 1}
# the ZeRO step's architectures: dense (the first: saved and restored by
# the elastic test), and MoE (experts over model, routing per shard)
ZERO_ARCHS = ("smollm-135m", "olmoe-1b-7b")


def _tree_np(tree):
    import jax
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device results and the job's inputs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get as rget
    from repro.configs import reduced as rreduced
    from repro.models import build

    out = {}
    # pipeline: reduced SmolLM, 2 layers (tests/test_pipeline_dist.py)
    cfg = rreduced(rget("smollm-135m")).with_(remat=False, n_layers=2)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab)
    out["pp_ref"] = np.asarray(m.forward(params, toks), np.float32)
    grads = jax.grad(lambda p: (m.forward(p, toks).astype(jnp.float32) ** 2
                                ).mean())(params)
    out["pp_grads"] = _tree_np(grads)
    out["pp_params"] = _tree_np(params)
    out["pp_tokens"] = np.asarray(toks, np.int32)
    # distributed decode: reduced Qwen2-72B
    cfg = rreduced(rget("qwen2-72b")).with_(remat=False)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab)
    _, cache = m.prefill(params, toks, max_len=64)
    lg, cache2 = m.decode_step(params, toks[:, 0], cache)
    out["dd_ref_logits"] = np.asarray(lg, np.float32)
    out["dd_ref_k"] = np.asarray(cache2["k"], np.float32)
    out["dd_params"] = _tree_np(params)
    out["dd_tokens"] = np.asarray(toks, np.int32)
    return out


def _zero_batch():
    cfg = reduced(get("smollm-135m"))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (4, 32), generator=g)
    return {"tokens": tok.numpy(), "labels": torch.roll(tok, -1, 1).numpy()}


@pytest.fixture(scope="module")
def job(reference, tmp_path_factory):
    work = tmp_path_factory.mktemp("dist")
    inputs = {k: reference[k] for k in
              ("pp_params", "pp_tokens", "dd_params", "dd_tokens")}
    inputs.update(zero_archs=ZERO_ARCHS, opt=OPT, zero_batch=_zero_batch())
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_dist_job.py"),
         str(work), str(WORLD)],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    outs = []
    for r in range(WORLD):
        with open(work / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return work, outs


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def test_pipeline_matches_sequential(reference, job):
    """GPipe over 2 stages of 1 layer, 4 microbatches: the logits on every
    rank within 1e-5 of the reference's sequential forward; each layer's
    gradient (from the rank of the stage that holds it) and the replicated
    leaves' gradients (on every rank) within 1e-6 of ``jax.grad``'s."""
    from repro_torch import interop
    _, outs = job
    for o in outs:
        assert np.abs(o["pp_logits"] - reference["pp_ref"]).max() < 1e-5
    cfg = reduced(get("smollm-135m")).with_(remat=False, n_layers=2)
    want = {n: p.detach().numpy() for n, p in interop.model_params_from_numpy(
        cfg, reference["pp_grads"], device="cpu").named_parameters()}
    seen = set()
    for o in outs:
        for name, g in o["pp_grads"].items():
            if name.startswith("layers."):
                layer = int(name.split(".")[1])
                if layer != o["pp_stage"]:       # 1 layer a stage
                    continue
            assert np.abs(g - want[name]).max() < 1e-6, name
            seen.add(name)
    assert seen == set(want)


# ---------------------------------------------------------------------------
# Distributed decode
# ---------------------------------------------------------------------------


def test_dist_decode_matches_single_device(reference, job):
    """The cache sequence-sharded over 4 model ranks (Shard(1)): the first
    step's logits and the written cache within 1e-4 of the reference's
    decode_step on one device, then 3 more steps finite."""
    _, outs = job
    for o in outs:
        assert "Shard(dim=1)" in o["dd_cache_placement"]
        assert np.abs(o["dd_logits"][0] - reference["dd_ref_logits"]
                      ).max() < 1e-4
        k = np.stack(o["dd_cache_k"])
        assert k.shape == reference["dd_ref_k"].shape
        assert np.abs(k - reference["dd_ref_k"]).max() < 1e-4
        assert all(np.isfinite(lg).all() for lg in o["dd_logits"][1:])
        assert len(o["dd_logits"]) == 4


# ---------------------------------------------------------------------------
# ZeRO step and elastic restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unsharded():
    """Each ZeRO architecture's 3 unsharded steps from the same init and
    batch."""
    torch.set_num_threads(1)
    out = {}
    for arch in ZERO_ARCHS:
        model = Model(reduced(get(arch)))
        state = opt.init_state(model.init(0, device="cpu"))
        step = steps.make_train_step(model, opt.OptConfig(**OPT))
        batch = {k: torch.from_numpy(v) for k, v in _zero_batch().items()}
        losses = []
        for _ in range(3):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        out[arch] = (state, losses)
    return out


@pytest.mark.parametrize("arch", ZERO_ARCHS)
def test_zero_step_matches_unsharded(job, unsharded, arch):
    """3 ZeRO steps on a (2, 2) mesh against 3 unsharded steps from the same
    init and batch. The data-parallel gradient sums and the tensor- and
    expert-parallel partial products add in another order than one
    device's products, so the losses agree to rtol 1e-6 and the masters
    and first moments to atol 1e-4: an AdamW update is about ``lr`` (3e-4
    here) per element, and a last-bit change in a gradient moves it by far
    less than a third of that (the measured gap is ~1e-5)."""
    state, losses = unsharded[arch]
    _, outs = job
    for o in outs:
        got = o[arch]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
        for name, p in state.params.named_parameters():
            np.testing.assert_allclose(got["masters"][name],
                                       p.detach().numpy(), atol=1e-4,
                                       err_msg=name)
            np.testing.assert_allclose(got["m"][name], state.m[name].numpy(),
                                       atol=1e-4, err_msg=name)
    # the masters live in the ZeRO layout: the q projection over data and
    # model, the embedding's vocabulary over model and its width over data
    pl, local = outs[0][arch]["placements"], outs[0][arch]["local"]
    assert pl["layers.0.attn.wq.w"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["embed.table"] == "(Shard(dim=1), Shard(dim=0))"
    assert local["layers.0.attn.wq.w"] == (64, 64)
    if arch == "olmoe-1b-7b":                 # 8 experts over 2 model ranks
        assert local["layers.0.moe.wi"][0] == 4


def test_elastic_restore_onto_other_meshes(job):
    """Saved from (2, 2), restored onto (4, 1) in the layout derived for it
    and equal to the saved state (verify_roundtrip at atol 0, and every
    master torch.equal); restored again on one device (no mesh) from the
    same files, equal to what the ranks saved."""
    from repro_torch.runtime import elastic
    work, outs = job
    for o in outs:
        assert o["elastic_ok"] and o["elastic_equal"]
        assert o["elastic_step"] == 3
        # [128, 128] over (4, 1): rows over 4 data ranks (64 x 64 on (2, 2))
        assert o["elastic_local"]["layers.0.attn.wq.w"] == (32, 128)
    cfg = reduced(get("smollm-135m"))
    template = opt.init_state(Model(cfg).init(1, device="cpu"))
    state = ckpt.restore(str(work / "ckpt"), 3, template)
    assert state.step == 3
    for name, p in state.params.named_parameters():
        assert np.array_equal(p.detach().numpy(),
                              outs[0][ZERO_ARCHS[0]]["masters"][name])
    assert elastic.verify_roundtrip(state, state, atol=0.0)


def test_checkpoint_streams_one_leaf_at_a_time(job):
    """A sharded save gathers one leaf, writes it on rank 0 and only then
    gathers the next (the other ranks gather and write nothing); a restore
    onto a mesh places each leaf before it reads the next. So no rank holds
    more than one whole leaf in host memory at once, whatever the state's
    size: a save that gathered every leaf before writing, or a restore that
    read every file before placing, gives another sequence here."""
    _, outs = job
    for rank, o in enumerate(outs):
        n = o["n_leaves"]
        want = (["write"] + ["gather", "write"] * n if rank == 0
                else ["gather"] * n)
        assert o["save_events"] == want, rank
        assert o["restore_events"] == ["read", "place"] * n + ["read"], rank


def test_hint_is_identity_without_mesh():
    x = torch.randn(2, 8, 4)
    assert ctx.active_mesh() is None
    assert ctx.hint(x, "data", "model", None) is x
    assert ctx.axis_size("model") == 1


def test_production_mesh_needs_its_world():
    """Without a process group of 256 ranks the production mesh raises,
    naming the fake process group the dry-run starts (the counterpart of
    the reference's XLA_FLAGS message)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="fake process group"):
        mesh_lib.make_production_mesh()
    assert mesh_lib.data_axes(type("M", (), {
        "axis_names": ("pod", "data", "model"),
        "shape": {"pod": 2, "data": 16, "model": 16}})()) == ("pod", "data")
