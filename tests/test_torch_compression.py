"""Gradient compression (``repro_torch.distributed.compression``) against
the reference's ``repro.distributed.compression``: int8 payloads and f32
scales bit for bit (both round half to even, in f32), ten error-feedback
steps equal, and the reference's four properties (tests/test_compression.py)
on the port."""
import numpy as np
import pytest
import torch

from repro_torch.distributed.compression import (ErrorFeedback, compress,
                                                 decompress, roundtrip_error)


@pytest.fixture(scope="module")
def ref():
    from repro.distributed import compression
    return compression


def _jnp(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


# shapes: a size that is not a multiple of 256, whole blocks, a matrix, a
# 3-d tensor, and one with exact .5 quotients (ties round to even)
CASES = [((1000,), "float32", 0.02), ((4096,), "float32", 1.0),
         ((7, 300), "float32", 0.1), ((3, 5, 7), "float32", 3.0),
         ((1000,), "bfloat16", 0.02), ((7, 300), "bfloat16", 1.0)]


@pytest.mark.parametrize("shape,dtype,scale", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{d}"
                              for s, d, _ in CASES])
def test_payload_and_scales_bit_equal(ref, shape, dtype, scale):
    import jax.numpy as jnp
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0, scale, shape)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    c = compress(xt)
    cj = ref.compress(xj)
    assert c.q.dtype == torch.int8 and c.scale.dtype == torch.float32
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(cj.q))
    np.testing.assert_array_equal(c.scale.numpy(), np.asarray(cj.scale))
    y = decompress(c, xt.shape)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(ref.decompress(cj, xj.shape)))
    np.testing.assert_array_equal(
        roundtrip_error(xt).float().numpy(),
        np.asarray(ref.roundtrip_error(xj)).astype(np.float32))


def test_ties_round_half_to_even(ref):
    """A block whose max is 127 makes the scale exactly 1.0: x.5 values
    quantize to the even neighbour in both packages."""
    x = np.zeros(256, np.float32)
    x[0] = 127.0
    x[1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 3.5]
    c = compress(torch.from_numpy(x))
    assert c.q[0, 1:9].tolist() == [0, 2, 2, 0, -2, -2, 126, 4]
    np.testing.assert_array_equal(c.q.numpy(),
                                  np.asarray(ref.compress(_jnp(x)).q))


def test_error_feedback_ten_steps_equal(ref):
    rng = np.random.default_rng(3)
    shapes = {"a": (300,), "b": (17, 33)}
    grads = [{k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(10)]
    res = ErrorFeedback.init({k: torch.zeros(s) for k, s in shapes.items()})
    rres = ref.ErrorFeedback.init({k: _jnp(np.zeros(s, np.float32))
                                   for k, s in shapes.items()})
    for g in grads:
        g_hat, res = ErrorFeedback.apply(
            {k: torch.from_numpy(v) for k, v in g.items()}, res)
        rg, rres = ref.ErrorFeedback.apply({k: _jnp(v) for k, v in g.items()},
                                           rres)
        for k in shapes:
            np.testing.assert_array_equal(g_hat[k].numpy(), np.asarray(rg[k]))
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(rres[k]))


# the reference's four properties, on the port


def test_roundtrip_accuracy():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.02, (1000,)).astype(np.float32))
    y = decompress(compress(x), x.shape)
    # int8 symmetric: relative block error bounded by ~1/127
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127 + 1e-8


def test_compression_ratio():
    x = torch.ones(4096)
    c = compress(x)
    payload = c.q.numel() * 1 + c.scale.numel() * 4
    assert payload < 0.3 * x.numel() * 4      # ~4x smaller than f32


def test_error_feedback_unbiased_accumulation():
    """Sum of compressed grads + final residual == sum of true grads."""
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.normal(0, 0.1, (300,)).astype(np.float32))
             for _ in range(20)]
    residual = ErrorFeedback.init({"g": grads[0]})
    acc = torch.zeros(300)
    for g in grads:
        g_hat, residual = ErrorFeedback.apply({"g": g}, residual)
        acc = acc + g_hat["g"]
    true = sum(g.numpy().astype(np.float64) for g in grads)
    np.testing.assert_allclose((acc + residual["g"]).numpy(), true,
                               rtol=1e-5, atol=1e-5)
    assert float(np.abs(acc.numpy() - true).max()) < 0.01


def test_error_feedback_sgd_converges():
    """Quadratic optimization with compressed grads still converges."""
    w = torch.tensor([5.0, -3.0, 2.0])
    residual = ErrorFeedback.init({"w": w})
    for _ in range(300):
        g_hat, residual = ErrorFeedback.apply({"w": w}, residual)
        w = w - 0.05 * g_hat["w"]
    assert float(w.abs().max()) < 0.05
