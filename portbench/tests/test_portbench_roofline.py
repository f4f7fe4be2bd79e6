"""The frozen roofline arithmetic against a hand count on a tiny panel."""
import pytest
import torch

from portbench import roofline


def test_k1a_bound_by_hand():
    n = 10
    C, T, S = 2, 4, 3
    tpos = torch.zeros(C, T, 3)
    tidx = torch.tensor([[0, 1, 2, n], [3, 4, n, n]])          # 5 real
    spos, smass = torch.zeros(S, 3), torch.ones(S)
    sidx = torch.arange(S)
    mask = torch.tensor([[True, True, False], [True, True, True]])
    pairs = 2 * 3 + 3 * 2                                       # 12
    nbytes = (C * T * 3 * 4 + C * T * 8 + S * 3 * 4 + S * 4 + S * 8
              + C * S * 1 + C * T * 4 * 4)
    s, by = roofline.k1a_bound((tpos, tidx, spos, smass, sidx, mask), n)
    want = max(nbytes / roofline.PEAK_BYTES,
               pairs * 20 / roofline.PEAK_FP32)
    assert s == pytest.approx(want, rel=1e-12)
    assert by == "bytes"


def test_k1a_bound_turns_to_operations_on_a_dense_panel():
    n = 4096
    C, T, S = 4, 1024, 4096
    inputs = (torch.zeros(C, T, 3), torch.arange(C * T).reshape(C, T) % n,
              torch.zeros(S, 3), torch.ones(S), torch.arange(S),
              torch.ones(C, S, dtype=torch.bool))
    s, by = roofline.k1a_bound(inputs, n)
    assert by == "operations"
    assert s == pytest.approx(C * T * S * 20 / roofline.PEAK_FP32)
