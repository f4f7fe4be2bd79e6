"""The plain reference against a float64 NumPy sum on 64 particles."""
import numpy as np
import pytest
import torch

from portbench.reference import compare
from portbench.reference.direct import direct_sum, kicks


def numpy_sum(pos, mass, eps):
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    np.fill_diagonal(r2, np.inf)
    inv = 1.0 / np.sqrt(r2)
    acc = ((mass[None, :] * inv ** 3)[:, :, None] * d).sum(1)
    return acc, -(mass[None, :] * inv).sum(1)


@pytest.fixture
def cloud():
    rng = np.random.default_rng(7)
    return rng.normal(size=(64, 3)), rng.uniform(0.5, 1.5, 64)


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_direct_sum_matches_numpy(cloud, eps, monkeypatch):
    pos, mass = cloud
    want_a, want_p = numpy_sum(pos, mass, eps)
    # passes of a few sources and targets, as on the card at scale
    monkeypatch.setattr("portbench.reference.direct.SOURCE_BLOCK", 16)
    monkeypatch.setattr("portbench.reference.direct.PASS_BYTES", 4096)
    rows = torch.arange(64)
    a, p = direct_sum(torch.tensor(pos), torch.tensor(mass),
                      torch.tensor(pos), rows, eps)
    np.testing.assert_allclose(a.numpy(), want_a, rtol=1e-12, atol=0)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-12, atol=0)
    sub = torch.tensor([3, 17, 40])
    a3, p3 = direct_sum(torch.tensor(pos), torch.tensor(mass),
                        torch.tensor(pos)[sub], sub, eps)
    np.testing.assert_allclose(a3.numpy(), want_a[[3, 17, 40]], rtol=1e-12)


def test_kicks_follow_a_numpy_leapfrog(cloud):
    pos, mass = cloud
    vel = np.random.default_rng(8).normal(size=(64, 3))
    dt, eps = 1e-3, 0.05
    a0, _ = numpy_sum(pos, mass, eps)
    vh = vel + 0.5 * dt * a0
    x1 = pos + dt * vh
    # the sources of the second half-kick at pos + dt vel (the reference's
    # stated shortcut), each target at its own drifted place
    src = pos + dt * vel
    d = src[None, :, :] - x1[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    np.fill_diagonal(r2, np.inf)
    a1 = ((mass[None, :] / r2 ** 1.5)[:, :, None] * d).sum(1)
    rows = torch.tensor([0, 5, 63])
    rx1, rv1 = kicks(torch.tensor(pos), torch.tensor(vel),
                     torch.tensor(mass), rows, dt, eps)
    np.testing.assert_allclose(rx1.numpy(), x1[[0, 5, 63]], rtol=1e-13)
    np.testing.assert_allclose(rv1.numpy(), (vh + 0.5 * dt * a1)[[0, 5, 63]],
                               rtol=1e-12)


def test_comparisons():
    ref_a = torch.tensor([[1.0, 0, 0], [0, 2.0, 0]], dtype=torch.float64)
    ref_p = torch.tensor([-1.0, -2.0], dtype=torch.float64)
    c = compare.answers(ref_a * 1.1, ref_p, ref_a, ref_p)
    assert c["force_rms"] == pytest.approx(0.1)
    assert c["pot_rms"] == 0.0
    assert c["answer_rms"] == pytest.approx(0.1)
    assert compare.is_permutation(torch.tensor([2, 0, 1]))
    assert not compare.is_permutation(torch.tensor([2, 2, 1]))
    assert not compare.is_permutation(torch.tensor([3, 0, 1]))
