"""The port's sharding plan (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), leaf for leaf.

Both derive specs on a stand-in 16 x 16 ``("data", "model")`` mesh (and
2 x 16 x 16 with ``"pod"``) with no devices behind it: the reference's
``jax.sharding.Mesh`` over fake devices (as ``tests/test_distributed.py``
builds it), the port's from anything with axis names and sizes. The
reference's parameters come from ``jax.eval_shape`` of its ``init`` and are
stacked ``[n_layers, ...]``; the port's are per layer, so each port leaf is
held to the reference's spec of its stacked leaf with the leading (layer)
entry dropped. The only leaves where that entry names a mesh axis are the
ZeRO layer-dim fallback's (listed exactly below; the port replicates them
over data).
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCHS, SHAPES, get
from repro_torch.distributed import dist_decode
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import MP, P
from repro_torch.models.model import Model

ARCH_IDS = list(ARCHS)


class StandInMesh:
    """Axis names and sizes, nothing else (the port's spec derivation needs
    no process group)."""

    def __init__(self, shape=(16, 16), axes=("data", "model")):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESH = StandInMesh()
POD_MESH = StandInMesh((2, 16, 16), ("pod", "data", "model"))

#: The reference's stacked leaves whose ZeRO spec shards the layer dim (no
#: inner dim divides the data size); the port replicates each of their
#: per-layer tensors over data. Keyed by mesh, then architecture.
LAYER_AXIS_DROPPED = {
    (16, 16): {
        "qwen2-72b": ["layers/attn/wq/b"],
        "mamba2-2.7b": ["layers/A_log", "layers/D", "layers/conv_w",
                        "layers/dt_bias"],
    },
    (2, 16, 16): {
        "mamba2-2.7b": ["layers/A_log", "layers/D", "layers/conv_w",
                        "layers/dt_bias"],
    },
}


@pytest.fixture(scope="module")
def ref():
    import jax
    from jax.sharding import Mesh, PartitionSpec

    from repro import configs as rconfigs
    from repro.distributed import dist_decode as rdd
    from repro.distributed import sharding as rshd
    from repro.models import build as rbuild

    def fake_mesh(shape, axes):
        devs = np.empty(shape, object)

        class FakeDev:
            def __init__(self, i):
                self.id = i

        for i, idx in enumerate(np.ndindex(shape)):
            devs[idx] = FakeDev(i)
        return Mesh(devs, axes)

    def path_str(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def flat(tree, is_spec=False):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=(lambda x: isinstance(x, PartitionSpec))
            if is_spec else None)[0]
        return {path_str(k): v for k, v in leaves}

    cache = {}

    def params(arch):
        if arch not in cache:
            cfg = rconfigs.get(arch)
            model = rbuild(cfg)
            cache[arch] = (cfg, model,
                           jax.eval_shape(model.init, jax.random.PRNGKey(0)))
        return cache[arch]

    class Ref:
        pass

    r = Ref()
    r.jax, r.shd, r.dd, r.params, r.flat = jax, rshd, rdd, params, flat
    r.mesh = fake_mesh((16, 16), ("data", "model"))
    r.pod_mesh = fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return r


def _norm(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _port_params(arch):
    cfg = get(arch)
    with torch.device("meta"):
        return cfg, interop._param_module(cfg)(cfg)


def _check_tree(ref_specs, shapes, port_specs, stacked_keys):
    """Every port leaf's spec equals its reference leaf's with the leading
    entry dropped where the reference stacks it; returns the reference
    paths whose dropped entry named an axis."""
    dropped = set()
    n_port = 0
    for path, rs in ref_specs.items():
        shape = shapes[path]
        top = path.split("/")[0]
        full = _norm(rs, len(shape))
        if top in stacked_keys:
            rest = path[len(top) + 1:].replace("/", ".")
            if full[0] is not None:
                dropped.add(path)
            for i in range(shape[0]):
                got = port_specs[f"{top}.{i}.{rest}"]
                assert _norm(got, len(shape) - 1) == full[1:], (path, i)
                n_port += 1
        else:
            got = port_specs[path.replace("/", ".")]
            assert _norm(got, len(shape)) == full, path
            n_port += 1
    assert n_port == len(port_specs)
    return sorted(dropped)


@pytest.mark.parametrize("pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_zero_specs_match_reference(ref, arch, pod):
    rcfg, _, sds = ref.params(arch)
    jmesh, pmesh = (ref.pod_mesh, POD_MESH) if pod else (ref.mesh, MESH)
    shapes = {k: v.shape for k, v in ref.flat(sds).items()}
    cfg, module = _port_params(arch)
    stacked = type(module).STACKED
    dropped = _check_tree(ref.flat(ref.shd.param_specs(sds, jmesh, rcfg),
                                   True),
                          shapes, shd.param_specs(module, pmesh, cfg),
                          stacked)
    assert dropped == []          # TP never shards the layer dim
    dropped = _check_tree(ref.flat(ref.shd.opt_specs(sds, jmesh, rcfg), True),
                          shapes, shd.opt_specs(module, pmesh, cfg), stacked)
    want = LAYER_AXIS_DROPPED[(2, 16, 16) if pod else (16, 16)].get(arch, [])
    assert dropped == want
    # layer_axis_dropped names exactly their per-layer tensors
    got = shd.layer_axis_dropped(module, pmesh, cfg)
    n_layers = {p: shapes[p][0] for p in want}
    assert got == sorted(f"{p.split('/')[0]}.{i}."
                         + p.split("/", 1)[1].replace("/", ".")
                         for p in want for i in range(n_layers[p]))


@pytest.mark.parametrize("enabled", [False, True], ids=["kv", "dist_decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(ref, arch, enabled,
                                               monkeypatch):
    """Every SHAPES entry's input specs (cache included for the decode
    shapes), with and without the distributed decode's sequence-sharded
    cache."""
    rcfg, rmodel, _ = ref.params(arch)
    cfg = get(arch)
    model = Model(cfg)
    monkeypatch.setattr(ref.dd, "ENABLED", enabled)
    monkeypatch.setattr(dist_decode, "ENABLED", enabled)
    for shape in SHAPES.values():
        rin = rmodel.input_specs(shape)
        pin = model.input_specs(shape)
        assert list(rin) == list(pin)
        rspecs = ref.shd.batch_specs(rcfg, rin, ref.mesh)
        pspecs = shd.batch_specs(cfg, pin, MESH)
        for name in rin:
            if name != "cache":
                assert _norm(pspecs[name], len(rin[name].shape)) == \
                    _norm(rspecs[name], len(rin[name].shape)), name
                continue
            rflat = ref.flat(rspecs["cache"], True)
            rshape = {k: v.shape for k, v in ref.flat(rin["cache"]).items()}
            _check_cache(rflat, rshape, pspecs["cache"], pin["cache"])


def _check_cache(rflat, rshape, pspecs, pcache):
    """The port's cache specs (per-layer lists) against the reference's
    stacked ones: k/v/ssm/conv lists and the hybrid's list of blocks take
    the stacked leaf's spec minus its leading entry; the rest map one to
    one; ``pos`` is replicated on both sides."""
    seen = 0
    for path, rs in rflat.items():
        parts = path.split("/")
        shape = rshape[path]
        full = _norm(rs, len(shape))
        if parts[0] in ("k", "v", "ssm", "conv"):
            for i, s in enumerate(pspecs[parts[0]]):
                assert _norm(s, len(shape) - 1) == full[1:], (path, i)
                assert full[0] is None
                seen += 1
        elif parts[0] == "blocks":
            for i, blk in enumerate(pspecs["blocks"]):
                assert _norm(blk[parts[1]], len(shape) - 1) == full[1:]
                seen += 1
        elif parts[0] == "tail":
            assert _norm(pspecs["tail"][parts[1]][parts[2]],
                         len(shape)) == full
            seen += 1
        else:
            assert _norm(pspecs[parts[0]], len(shape)) == full, path
            seen += 1
    assert seen > 0


# ---------------------------------------------------------------------------
# The reference's spec tests (tests/test_distributed.py), on the port
# ---------------------------------------------------------------------------


def test_param_specs_dense():
    cfg, module = _port_params("qwen2-7b")
    specs = shd.param_specs(module, MESH, cfg)
    # attention q: TP on the head dim (the layer entry dropped)
    assert specs["layers.0.attn.wq.w"] == P(None, "model")
    # kv heads (4) don't divide model=16 -> replicated (Megatron KV dup)
    assert specs["layers.0.attn.wk.w"] == P()
    assert specs["layers.0.mlp.wi.w"] == P(None, "model")
    assert specs["layers.0.mlp.wo.w"] == P("model", None)
    assert specs["embed.table"] == P("model", None)
    assert specs["layers.0.ln1.scale"] == P()


def test_param_specs_moe_experts():
    cfg, module = _port_params("qwen3-moe-30b-a3b")
    specs = shd.param_specs(module, MESH, cfg)
    # experts [E, D, F] sharded over model (EP)
    assert specs["layers.0.moe.wi"] == P("model", None, None)
    assert specs["layers.0.moe.router.w"] == P(None, None)


def test_zero_spec_adds_data_axis():
    spec = shd.zero_spec(P(None, None, "model"), (80, 8192, 1848), MESH)
    assert spec == P("data", None, "model")
    # non-divisible first dims skip to the next
    spec = shd.zero_spec(P(None, None), (5, 4096), MESH)
    assert spec == P(None, "data")


def test_cache_specs_prefer_heads_then_hd():
    cfg = get("olmoe-1b-7b")      # kv=16 -> heads shardable
    specs = shd.cache_specs_tree(cfg, Model(cfg).cache_specs(128, 1024),
                                 MESH)
    assert specs["k"][0] == P("data", None, "model", None)
    cfg2 = get("qwen2-72b")       # kv=8 -> fall to head_dim
    specs2 = shd.cache_specs_tree(cfg2, Model(cfg2).cache_specs(128, 1024),
                                  MESH)
    assert specs2["k"][0] == P("data", None, None, "model")
    assert len(specs2["k"]) == cfg2.n_layers and specs2["pos"] == P()


def test_batch_specs_drop_indivisible():
    cfg = get("mamba2-2.7b")
    specs = shd.batch_specs(cfg, Model(cfg).input_specs(SHAPES["long_500k"]),
                            MESH)
    assert specs["token"] == P(None)   # batch 1 can't shard over 16


def test_placements_of_specs():
    """A spec's DTensor placements: per mesh dim the tensor dim it shards,
    a tensor dim over ("pod", "data") sharded on both, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")

    assert shd.placements(P(("pod", "data"), None, MP), Mesh3()) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(P(), Mesh3()) == (Replicate(),) * 3
    assert shd.named({"a": [P(None, "data")]}, Mesh3()) == {
        "a": [(Replicate(), Shard(1), Replicate())]}
