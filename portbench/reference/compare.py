"""The comparisons that decide `correct`: the program's answers at the
sampled targets against the reference's, in float64."""
from __future__ import annotations

import torch


def _rel(got, want):
    """|got - want| / |want| a row (vectors [k, 3]) or an element ([k])."""
    got = got.to(torch.float64)
    if want.dim() == 2:
        return (torch.linalg.norm(got - want, dim=1)
                / torch.linalg.norm(want, dim=1))
    return (got - want).abs() / want.abs()


def _rms(x) -> float:
    return float(torch.sqrt(torch.mean(x * x)))


def answers(acc, pot, ref_acc, ref_pot) -> dict:
    """force_rms and pot_rms: the RMS over the targets of the relative
    error of the force and of the potential; a target's answer error is
    the root of the sum of the two squares: answer_rms, their RMS, and
    answer_max, the widest."""
    f = _rel(acc, ref_acc)
    p = _rel(pot, ref_pot)
    a = torch.sqrt(f * f + p * p)
    return {"force_rms": _rms(f), "pot_rms": _rms(p), "answer_rms": _rms(a),
            "answer_max": float(a.max())}


def step(x0, v0, x1, v1, ref_x1, ref_v1) -> dict:
    """kick_rms and kick_max: the RMS and the widest over the sampled
    particles of the relative error of the step's change of velocity
    (both half-kicks); drift_rms and drift_max: those of the change of
    position. x0, v0 are the particles before the step,
    x1, v1 the program's after it, ref_x1, ref_v1 the reference's."""
    x0, v0 = x0.to(torch.float64), v0.to(torch.float64)
    kick = _rel(v1.to(torch.float64) - v0, ref_v1 - v0)
    drift = _rel(x1.to(torch.float64) - x0, ref_x1 - x0)
    return {"kick_rms": _rms(kick), "kick_max": float(kick.max()),
            "drift_rms": _rms(drift), "drift_max": float(drift.max())}


def is_permutation(perm) -> bool:
    """Whether perm [n] takes each of 0..n-1 exactly once."""
    n = perm.shape[0]
    if perm.min() < 0 or perm.max() >= n:
        return False
    return bool((torch.bincount(perm, minlength=n) == 1).all())
