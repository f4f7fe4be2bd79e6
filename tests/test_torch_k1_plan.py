"""K1's plan (kernels/shared.py:fused_plan) on CPU tensors: each tile's
active granules of GRANULE sources against a NumPy brute force, the spans
of the work layout against the lists they cut, and the plain version's
compensated sums at other granules and span lengths (the kernel itself
runs only on a card; chip_smoke.py holds it and the plan its kernels
build against these there)."""
import numpy as np
import pytest
import torch

from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, shared

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

G = shared.GRANULE


def random_mask(seed, C, S, density):
    """A random mask with an empty tile (1), a full tile (2) and a tile
    whose only live entry is the row's last (3)."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(C, S)) < density
    mask[1] = False
    mask[2] = True
    mask[3] = False
    mask[3, -1] = True
    return mask


def brute_lists(mask, granule):
    """Per tile, the granules holding a live entry, in row order."""
    C, S = mask.shape
    ng = max(1, -(-S // granule))
    return [[g for g in range(ng)
             if mask[c, g * granule:(g + 1) * granule].any()]
            for c in range(C)]


@pytest.mark.parametrize("S", [G * 5 + 37, G * 4, 70, 3000])
@pytest.mark.parametrize("density", [0.002, 0.3])
def test_granule_lists_match_a_brute_force(S, density):
    mask = random_mask(int(S * 10 + density * 1000), 6, S, density)
    plan = shared.fused_plan(torch.as_tensor(mask))
    want = brute_lists(mask, G)
    ng = max(1, -(-S // G))
    assert plan.ids.shape == (6, ng) and plan.ids.dtype == torch.int32
    assert plan.cnt.dtype == torch.int32
    for c in range(6):
        n = len(want[c])
        assert int(plan.cnt[c]) == n
        assert plan.ids[c, :n].tolist() == want[c]
        assert (plan.ids[c, n:] == ng).all()
    assert plan.cnt[1] == 0 and plan.cnt[2] == ng
    assert plan.ids[3, :1].tolist() == [ng - 1]


def spans_of(plan, span):
    """The work layout expanded: per tile the list entries its live spans
    cover, span after span in the order of the work list."""
    C = plan.cnt.shape[0]
    covered = [[] for _ in range(C)]
    seen = []
    for v in plan.work[:int(plan.n_work[0])].tolist():
        c, z = divmod(v, plan.zmax)
        seen.append((c, z))
        lo, hi = z * span, min((z + 1) * span, int(plan.cnt[c]))
        assert lo < hi, "a live span holds at least one entry"
        covered[c].extend(plan.ids[c, lo:hi].tolist())
    return covered, seen


@pytest.mark.parametrize("span", [1, 3, shared.SPAN, 64])
def test_work_layout_covers_every_active_granule_once_in_order(span):
    S = G * 37 + 5
    mask = random_mask(span, 8, S, 0.004)
    mask[5, : G * 30] = True          # a long list beside ...
    mask[6] = False                   # ... a tile with none
    plan = shared.fused_plan(torch.as_tensor(mask), span=span)
    ng = -(-S // G)
    assert plan.zmax == -(-ng // span)
    assert plan.work.shape == (8 * plan.zmax,)
    covered, seen = spans_of(plan, span)
    assert seen == sorted(seen)                       # tile-major order
    assert len(set(seen)) == len(seen)
    for c in range(8):
        n = int(plan.cnt[c])
        assert covered[c] == plan.ids[c, :n].tolist()
        assert sum(1 for sc, _ in seen if sc == c) == -(-n // span)
    assert int(plan.n_work[0]) == sum(-(-int(n) // span)
                                      for n in plan.cnt.tolist())


def test_an_all_masked_row_has_no_work():
    plan = shared.fused_plan(torch.zeros((3, 500), dtype=torch.bool))
    assert plan.cnt.tolist() == [0, 0, 0] and int(plan.n_work[0]) == 0
    plan = shared.fused_plan(torch.zeros((2, 0), dtype=torch.bool))
    assert plan.ids.shape == (2, 1) and int(plan.n_work[0]) == 0


# (granule, span) plans of the plain version; span 0: one span a tile
PLANS = [(16, 1), (32, 0), (64, 3), (G, shared.SPAN), (256, 2)]


def test_compensated_sums_beat_fp32_at_every_granule_and_span():
    """The bound of test_compensated_sum_is_closer_to_float64 at every
    plan: on a long cancellation-heavy row the TwoSum sums land at least
    as close to the float64 sum as the fp32 ones."""
    rng = np.random.default_rng(8)
    C, T, S = 1, 8, 4096
    tpos = (rng.standard_normal((C, T, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((S, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (S, 1))
    mass = rng.uniform(1e-6, 10.0, S)
    d = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(d, axis=-1)).sum(-1)
    args = [torch.as_tensor(a) for a in (
        tpos, np.arange(T, dtype=np.int64)[None], src.astype(np.float32),
        mass.astype(np.float32), np.full(S, -1, np.int64),
        np.ones((C, S), bool))]
    for block, span in PLANS:
        errs = {}
        for comp in (False, True):
            _, p = shared.eval_shared_plain(
                *args, shared.scalar_buffer(0.0, 1.0, args[0]), mode="pot",
                block=block, span=span, compensated=comp)
            errs[comp] = np.abs(p.numpy().astype(np.float64)
                                - pot_ref).max()
        assert errs[True] <= errs[False], (block, span, errs)


def test_each_evaluator_names_its_plan():
    """K1 (fused) and K6 (mma) plan at GRANULE, K5 (blocks) at BLOCK;
    processed_pairs follows the evaluator that takes each launch."""
    from rakau_tpu_torch import metrics
    assert shared.PLAN_BLOCK == {"fused": shared.GRANULE,
                                 "mma": shared.GRANULE,
                                 "blocks": shared.BLOCK}
    assert shared.GRANULE in (128, 256) and shared.BLOCK % G == 0
    mask = torch.zeros((2, 3000), dtype=torch.bool)
    mask[0, 5] = mask[0, 2050] = mask[1, 1030] = True
    cfg = TreeConfig(ncrit=64, m2p_cap=1000, farfield="m2p")
    fused = metrics.processed_pairs(cfg, mask)
    assert int(fused) == 3 * G * 64
    with dispatch.shared_variant("mma"):
        assert int(metrics.processed_pairs(cfg, mask)) == 3 * G * 64
        # a compensated launch stays with K1
        comp = cfg.with_(accum="compensated")
        assert int(metrics.processed_pairs(comp, mask)) == 3 * G * 64
    assert int(metrics.processed_pairs(cfg, mask, "blocks")) \
        == 3 * shared.BLOCK * 64
    # quadrupole: the node rows [0, m2p_cap) are K1's in every variant,
    # the particle rows K6's (K1's granules) or K5's (blocks)
    quad = cfg.with_(multipole_order=2)
    with dispatch.shared_variant("mma"):
        assert int(metrics.processed_pairs(quad, mask)) == (G + 2 * G) * 64
    assert int(metrics.processed_pairs(quad, mask, "blocks")) \
        == (G + 2 * shared.BLOCK) * 64
