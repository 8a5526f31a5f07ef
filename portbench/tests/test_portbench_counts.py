"""The yardstick's operations and bytes against hand-worked shapes."""
import pytest

from portbench import counts as C

H100 = C.PEAKS["NVIDIA H100 80GB HBM3"]


def test_attention_worked_example():
    # two sequences of 4,096, 28 query and 4 KV heads of 128 (the module's
    # worked example): S(S+1)/2 pairs a head at 4 * 128 operations each
    assert C.attention_flops(4096, 28, 128, batch=2) == \
        2 * 4 * 128 * 28 * (4096 * 4097 // 2)
    assert C.attention_bytes(4096, 28, 4, 128, batch=2) == \
        2 * (28 + 28 + 4 + 4) * 4096 * 128 * 2
    least = C.attention_least_s(4096, 28, 4, 128, H100, batch=2)
    assert least == pytest.approx(240.576888832e9 / 989e12)
    assert least * 1e3 == pytest.approx(0.24325, abs=1e-5)


def test_attention_one_token_is_bytes_bound():
    # one query over itself: 4 * hd * H operations, and q, k, v, out
    assert C.attention_flops(1, 2, 8) == 4 * 8 * 2
    assert C.attention_bytes(1, 2, 1, 8) == (2 * 2 + 2 * 1) * 8 * 2
    assert C.attention_least_s(1, 2, 1, 8, H100) == pytest.approx(
        96 / 3.35e12)


DENSE = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
             d_ff=16, vocab=10)
MOE = dict(DENSE, n_experts=4, top_k=2, d_expert=6)


def test_layer_params_by_hand():
    attn = 8 * 4 * (2 + 2) + 2 * 4 * 8           # q, k, v; o
    assert C.layer_matmul_params(DENSE) == attn + 3 * 8 * 16
    assert C.layer_matmul_params(MOE) == attn + 8 * 4 + 2 * 3 * 8 * 6


def test_request_flops_by_hand():
    p = C.layer_matmul_params(DENSE)
    S = 5
    prefill = 2 * 2 * p * S + 2 * (2 * 4 * 2 * S * (S + 1)) + 2 * 8 * 10
    assert C.prefill_flops(DENSE, S) == prefill
    # decode at position 5 attends to 6 keys
    dec = 2 * 2 * p + 2 * 4 * 4 * 2 * 6 + 2 * 8 * 10
    assert C.decode_flops(DENSE, 5) == dec
    assert C.request_flops(DENSE, S, 3) == prefill + dec + \
        C.decode_flops(DENSE, 6)
    assert C.request_flops(DENSE, S, 1) == prefill


def test_unknown_card_has_no_peaks():
    assert C.peaks("NVIDIA H100 80GB HBM3") is H100
    assert C.peaks("cpu") is None
