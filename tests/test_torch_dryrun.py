"""The port's dry-run (``repro_torch.launch.dryrun``) at reduced width on a
4 x 4 fake mesh: one cell per family, in a subprocess (the fake process
group of 16 ranks is process-wide state).

  * each cell's per-device argument bytes equal the sum over the
    reference's specs (``repro.distributed.sharding`` on a 4 x 4 mesh of
    fake devices) of each leaf's local shard;
  * a train cell moves its ZeRO traffic: all-gathers of the masters and
    reduce-scatters of the gradients, and ``CommDebugMode`` counts the
    collectives the dry-run tallies;
  * the FLOPs of a reduced dense prefill equal the count written out
    below, per device;
  * the peak of a reduced dense train cell with a large vocabulary equals,
    within 2%, its largest live set written out below, and a counter that
    never frees misses it.

``repro.launch.dryrun`` is never imported here (it rewrites XLA_FLAGS at
import).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
MESH = (4, 4)
B, S = 8, 64
# (arch, kind): one cell per family, plus the dense prefill of the FLOP count
CELLS = [("smollm-135m", "train"), ("smollm-135m", "prefill"),
         ("olmoe-1b-7b", "decode"), ("mamba2-2.7b", "train"),
         ("recurrentgemma-2b", "prefill"), ("seamless-m4t-medium", "decode")]
# the peak's cell: reduced SmolLM, one layer, a vocabulary of 2^17, so that
# the cross-entropy's [b, S, V/4] tensors outweigh everything else
PEAK_VOCAB = 1 << 17

SCRIPT = """
import json, sys, warnings
warnings.filterwarnings("ignore")
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
dryrun.fake_world(16)
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
for arch, kind in json.loads(sys.argv[1]):
    cfg = reduced(get(arch)).with_(dtype="bfloat16")
    r = dryrun.lower_cell(arch, kind, mesh, cfg=cfg,
                          shape=ShapeConfig(kind, %d, %d, kind))
    print("CELL " + json.dumps(r), flush=True)


class NeverFrees(dryrun._Counting):
    def _free(self, nbytes):
        pass


counters = dryrun._Counting
for tag, counter in (("PEAK", counters), ("NEVER_FREES", NeverFrees)):
    dryrun._Counting = counter
    cfg = reduced(get("smollm-135m")).with_(dtype="bfloat16", n_layers=1,
                                             vocab=%d)
    r = dryrun.lower_cell("smollm-135m", "train", mesh, cfg=cfg,
                          shape=ShapeConfig("train", %d, %d, "train"))
    print(tag + " " + json.dumps(r), flush=True)
dryrun._Counting = counters
""" % (S, B, PEAK_VOCAB, S, B)


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = {}
    for line in proc.stdout.splitlines():
        tag, _, rec = line.partition(" ")
        if tag == "CELL":
            r = json.loads(rec)
            out[(r["arch"], r["kind"])] = r
        elif tag in ("PEAK", "NEVER_FREES"):
            out[tag] = json.loads(rec)
    return out


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec

    from repro import configs as rconfigs
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding as rshd
    from repro.models import build

    devs = np.empty(MESH, object)

    class FakeDev:
        def __init__(self, i):
            self.id = i

    for i, idx in enumerate(np.ndindex(MESH)):
        devs[idx] = FakeDev(i)
    mesh = Mesh(devs, ("data", "model"))
    sizes = dict(zip(("data", "model"), MESH))

    def local_bytes(sds, spec, itemsize=None):
        shape = list(sds.shape)
        for d, ax in enumerate(tuple(spec)):
            for a in (() if ax is None else (ax,) if isinstance(ax, str)
                      else ax):
                shape[d] //= sizes[a]
        return int(np.prod(shape)) * (itemsize or
                                      jnp.dtype(sds.dtype).itemsize)

    def tree_bytes(sds_tree, spec_tree, itemsize=None, skip=()):
        leaves = jax.tree_util.tree_flatten_with_path(sds_tree)[0]
        specs = jax.tree_util.tree_flatten(
            spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
        return sum(local_bytes(s, p, itemsize) for (path, s), p in
                   zip(leaves, specs)
                   if not any(getattr(k, "key", None) in skip for k in path))

    def argument_bytes(arch, kind):
        """The reference's per-device argument bytes of the cell: the train
        state (f32 masters and both moments in the ZeRO specs; its int32
        step counter left out: the port keeps the step on the host), or
        bf16 parameters in the TP specs, plus the batch (and the cache, its
        int32 ``pos`` left out likewise)."""
        cfg = rconfigs.reduced(rconfigs.get(arch)).with_(dtype="bfloat16")
        model = build(cfg)
        psds = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        inputs = model.input_specs(ShapeConfig(kind, S, B, kind))
        bspecs = rshd.batch_specs(cfg, inputs, mesh)
        if kind == "train":
            total = 3 * tree_bytes(psds, rshd.opt_specs(psds, mesh, cfg), 4)
        else:
            total = tree_bytes(psds, rshd.param_specs(psds, mesh, cfg), 2)
        for name, leaf in inputs.items():
            if name == "cache":
                total += tree_bytes(leaf, bspecs[name], skip=("pos",))
            else:
                total += local_bytes(leaf, bspecs[name])
        return total

    return argument_bytes


@pytest.mark.parametrize("arch,kind", CELLS,
                         ids=[f"{a}-{k}" for a, k in CELLS])
def test_argument_bytes_from_reference_specs(cells, ref, arch, kind):
    r = cells[(arch, kind)]
    assert r["mesh"] == "4x4" and r["n_devices"] == 16 and r["host"]
    assert r["argument_size"] == ref(arch, kind)
    assert r["peak_bytes"] >= r["argument_size"] > 0
    assert r["flops"] > 0


def test_train_cell_moves_zero_traffic(cells):
    for arch in ("smollm-135m", "mamba2-2.7b"):
        r = cells[(arch, "train")]
        coll = r["collectives"]
        assert coll["all-gather"]["count"] > 0 and coll["all-gather"]["bytes"]
        assert coll["reduce-scatter"]["count"] > 0
        assert coll["reduce-scatter"]["bytes"] > 0
        # CommDebugMode sees the same collectives the dry-run tallies
        debug = r["comm_debug_counts"]
        assert debug.get("all_gather_into_tensor", 0) == \
            coll["all-gather"]["count"]
        assert debug.get("reduce_scatter_tensor", 0) == \
            coll["reduce-scatter"]["count"]
        assert debug.get("all_reduce", 0) + debug.get("allreduce_", 0) == \
            coll["all-reduce"]["count"]


def test_dense_prefill_flops_per_device(cells):
    """Reduced SmolLM (2 layers, D 128, 4 heads and 2 KV heads of 32, d_ff
    256, vocab 512, tied), prefill of 8 x 64 on 4 x 4: each device holds 2
    sequences (data) and a quarter of the heads, FFN and vocabulary
    (model). The KV projections are replicated (2 KV heads do not divide
    4), so every device computes them whole. Attention runs over the
    64-slot cache in full (masked, not skipped), and the unembedding only
    for the last position."""
    b, s, d, hd, f, v = 2, 64, 128, 32, 256, 512
    q_cols, kv_cols, ff_cols, v_cols = 4 * hd // 4, 2 * hd, f // 4, v // 4
    per_layer = (2 * b * s * d * q_cols            # wq (columns over model)
                 + 2 * 2 * b * s * d * kv_cols     # wk, wv (replicated)
                 + 2 * 2 * b * 1 * s * s * hd      # QK^T, PV (1 head)
                 + 2 * b * s * q_cols * d          # wo (rows over model)
                 + 2 * 2 * b * s * d * ff_cols     # wi, wg
                 + 2 * b * s * ff_cols * d)        # mlp wo
    want = 2 * per_layer + 2 * b * 1 * d * v_cols
    assert cells[("smollm-135m", "prefill")]["flops"] == want == 27_328_512


def test_train_peak_is_the_largest_live_set(cells):
    """Reduced SmolLM with one layer and a 2^17 vocabulary, train 8 x 64 on
    4 x 4 (f32 masters, bf16 compute, tied embedding; each device holds 2
    sequences and a quarter of the vocabulary). The step peaks in the
    forward's vocabulary-parallel cross-entropy, at the masked sum of the
    label logit, with these live beside the arguments: the embedding
    master all-gathered over data to [V/4, D] in f32 and its bf16 copy,
    the bf16 logits [b, S, V/4], the f32 logits, ``exp`` of them and the
    ``where`` of the label compare (all three f32 [b, S, V/4]), the compare's
    bool mask, and the int64 vocabulary index [V/4]. The layer's own
    activations and gathered weights (tens of KiB each) are the rest, under
    2%. A counter that never frees (every storage the step made is still
    counted) misses it by far; so does one that counts a view of an
    argument as new storage (the master's local shard, 4 MiB, is 4%)."""
    b, s, d, v = 2, S, 128, PEAK_VOCAB // 4
    live = (v * d * 4 + v * d * 2             # gathered table, f32 and bf16
            + b * s * v * 2                   # bf16 logits
            + 3 * b * s * v * 4               # f32 logits, exp, where
            + b * s * v * 1                   # label compare
            + v * 8)                          # vocabulary index
    r = cells["PEAK"]
    want = r["argument_size"] + live
    assert abs(r["peak_bytes"] - want) <= 0.02 * want, (r["peak_bytes"],
                                                        want)
    leaky = cells["NEVER_FREES"]
    assert leaky["argument_size"] == r["argument_size"]
    assert leaky["peak_bytes"] > 1.5 * want
