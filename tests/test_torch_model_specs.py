"""The dry-run stand-ins of ``repro_torch.models.model.Model``
(``input_specs``, ``cache_specs``, ``make_inputs``) against the reference's
(``repro/models/model.py``): the same names, shapes and dtypes for every
architecture and every SHAPES entry, with the port's cache layout (one
tensor per layer where the reference stacks ``[n_layers, ...]``; the
hybrid's blocks a list of per-block dicts; ``pos`` a host int, 0 as the
reference's zero stand-in); ``configs.cells`` and ``Model.param_count``
against the reference's."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get, reduced
from repro_torch.models.model import Model, TensorSpec

ARCH_IDS = list(ARCHS)
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "int32": torch.int32}


@pytest.fixture(scope="module")
def ref():
    import jax

    from repro import configs as rconfigs
    from repro.models import build
    return jax, rconfigs, build


def _same(tspec, sds):
    assert isinstance(tspec, TensorSpec)
    assert tuple(tspec.shape) == tuple(sds.shape)
    assert tspec.dtype == _DT[str(sds.dtype)]


def _check_cache(port, refc):
    """Port cache (per layer) against the reference's stacked cache."""
    assert set(port) == set(refc)
    for key, r in refc.items():
        if key == "pos":
            assert port["pos"] == 0 and r.shape == ()
        elif key == "blocks":                      # hybrid: [n_super, ...]
            n = next(iter(r.values())).shape[0]
            assert len(port["blocks"]) == n
            for blk in port["blocks"]:
                assert set(blk) == set(r)
                for name, leaf in r.items():
                    _same(blk[name], type(leaf)(leaf.shape[1:], leaf.dtype))
        elif key == "tail":
            assert set(port["tail"]) == set(r)
            for t, leaves in r.items():
                for name, leaf in leaves.items():
                    _same(port["tail"][t][name], leaf)
        elif key in ("k", "v", "ssm", "conv"):     # [n_layers, ...]
            assert len(port[key]) == r.shape[0]
            for leaf in port[key]:
                _same(leaf, type(r)(r.shape[1:], r.dtype))
        else:                                      # enc: [B, S, D]
            _same(port[key], r)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_reference(ref, arch):
    jax, rconfigs, build = ref
    rmodel = build(rconfigs.get(arch))
    model = Model(get(arch))
    for shape in SHAPES.values():
        rs, ps = rmodel.input_specs(shape), model.input_specs(shape)
        assert list(ps) == list(rs), shape.name
        for name, r in rs.items():
            if name == "cache":
                _check_cache(ps[name], r)
            else:
                _same(ps[name], r)
    _check_cache(model.cache_specs(3, 40), rmodel.cache_specs(3, 40))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_inputs_match_reference(ref, arch):
    """Concrete inputs at a reduced config and small shapes: the reference's
    shapes and dtypes, token ids inside the vocabulary, a zero cache, the
    same draw from the same seed and a different one from another."""
    jax, rconfigs, build = ref
    rmodel = build(reduced(rconfigs.get(arch)))
    model = Model(reduced(get(arch)))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("small", 24, 8, kind)
        rin = rmodel.make_inputs(shape, concrete_batch=2)
        pin = model.make_inputs(shape, seed=0, concrete_batch=2,
                                device="cpu")
        again = model.make_inputs(shape, seed=0, concrete_batch=2,
                                  device="cpu")
        other = model.make_inputs(shape, seed=1, concrete_batch=2,
                                  device="cpu")
        assert list(pin) == list(rin)
        for name, r in rin.items():
            if name == "cache":
                spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                    x.shape, x.dtype), r)
                _check_cache(_specs(pin["cache"]), spec)
                for t in _tensors(pin["cache"]):
                    assert not t.any()
                continue
            t = pin[name]
            _same(TensorSpec(tuple(t.shape), t.dtype), r)
            assert torch.equal(t, again[name])
            assert not torch.equal(t, other[name])
            if t.dtype == torch.int32:
                assert 0 <= int(t.min()) and int(t.max()) < model.cfg.vocab
            else:
                assert abs(float(t.std()) - 0.02) < 0.005


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    return tree


@pytest.mark.parametrize("include_skipped", [False, True])
def test_cells_match_reference(ref, include_skipped):
    """``configs.cells``: the reference's dry-run cells in its order, with
    the long_500k cells of the full-attention archs skipped or, with
    ``include_skipped``, marked so."""
    from repro_torch.configs import cells
    _, rconfigs, _ = ref
    want = list(rconfigs.cells(include_skipped=include_skipped))
    got = list(cells(include_skipped=include_skipped))
    assert got == want
    assert len(got) == len(ARCH_IDS) * len(SHAPES) - (
        0 if include_skipped else len(ARCH_IDS) - 2)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(ref, arch):
    """``Model.param_count`` of the port's parameters at the reduced config
    equals the reference's count of its pytree's leaves (taken from the
    shapes its init would make), and exceeds the analytic ``n_params`` by
    the vectors that leaves out."""
    jax, rconfigs, build = ref
    rmodel = build(reduced(rconfigs.get(arch)))
    model = Model(reduced(get(arch)))
    shapes = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    got = model.param_count(model.init(0, device="cpu"))
    assert got == rmodel.param_count(shapes)
    assert got > model.n_params()
