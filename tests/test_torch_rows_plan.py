"""The plans of K2 and K3 (kernels/pool.py:pool_plan, kernels/tiles.py:
tiles_plan) and their plain versions on CPU tensors: the plans against a
NumPy brute force (padding tiles, counts of 0, of the whole row and not a
multiple of the granule, a pool block of 200, 2-D), the spans cutting
exactly each tile's granules in order, and the plain K2 and K3 at other
granules and span lengths, in every form and mode, against
`pallas.eval_pool` / `eval_tiles(interpret=True)` at the reference's
kernel tolerance (rtol 2e-4, atol 2e-5). The kernels run only on a card;
chip_smoke.py holds them, and the plans their kernels build, against these
there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu.kernels import pallas as pk
from rakau_tpu_torch.kernels import pool, rows, shared, tiles

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
GR = rows.GRANULE
MODES = ("both", "acc", "pot")


def brute_plan(granules, span, cap):
    """(first, work, n_work) of tiles with these granule counts, by
    walking the tiles."""
    first, work = [0], []
    for g, k in enumerate(granules):
        n = -(-max(k, 0) // span)
        work += [g] * n
        first.append(first[-1] + n)
    bad = any(k < 0 for k in granules) or first[-1] > cap
    work = (work + [len(granules)] * cap)[:cap]
    return first, work, -1 if bad else first[-1]


def assert_plan(plan, granules, span, cap):
    first, work, n = brute_plan(granules, span, cap)
    assert plan.first.dtype == plan.work.dtype == torch.int32
    assert plan.first.tolist() == first
    assert plan.work.tolist() == work
    assert plan.n_work.tolist() == [n]


# ------------------------------------------------------------------- K2
def brute_pool_granules(sched, window, block, P):
    """Per tile, its granules as (first row, rows, node block?) in order,
    or None for a schedule row out of range."""
    out = []
    nblocks = -(-P // block)
    for w, s, m, p in sched:
        base = w * (window // block) + s
        if m < 0 or p < 0 or (m + p and (w < 0 or s < 0
                                         or base + m + p > nblocks)):
            out.append(None)
            continue
        grans = []
        for b in range(m + p):
            for r0 in range(0, block, GR):
                grans.append(((base + b) * block + r0,
                              min(GR, block - r0), b < m))
        out.append(grans)
    return out


# (window, block, P, sched): padding tiles, a long segment beside short
# ones, blocks of 200 (not a multiple of the granule) and of 128
POOL_CASES = [
    (2048, 512, 4096, [[0, 0, 1, 2], [0, 3, 0, 1], [1, 0, 2, 1],
                       [0, 0, 0, 0], [1, 3, 1, 0]]),
    (800, 200, 2400, [[0, 0, 2, 2], [1, 0, 0, 0], [1, 0, 1, 3],
                      [2, 0, 0, 1], [2, 1, 3, 0], [0, 0, 0, 0]]),
    (16384, 128, 16384, [[0, 0, 40, 60], [0, 100, 1, 0], [0, 101, 0, 2],
                         [0, 0, 0, 0], [0, 103, 3, 4]]),
]


@pytest.mark.parametrize("span", [1, 3, pool.SPAN])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool_plan_matches_a_brute_force(case, span):
    window, block, P, sched = POOL_CASES[case]
    st = torch.tensor(sched, dtype=torch.int32)
    want = brute_pool_granules(sched, window, block, P)
    counts = [-1 if g is None else len(g) for g in want]
    assert pool.pool_granules(st, window, block, P).tolist() == counts
    cap = pool.span_capacity(len(sched), P, window, block, span)
    assert sum(-(-k // span) for k in counts) <= cap
    assert_plan(pool.pool_plan(st, window, block, P, span), counts, span,
                cap)
    for k in range(max(counts)):
        r0, nr, node = pool.granule_rows(st, window, block, k)
        for g, grans in enumerate(want):
            if k < len(grans):
                assert (int(r0[g]), nr, bool(node[g])) == grans[k]


def test_pool_plan_flags_rows_out_of_range_and_overlaps():
    """A schedule row past the pool or with a negative count, and
    segments that overlap past the capacity, give n_work = -1 (the
    kernel's reduction then writes NaN, not a silent wrong sum)."""
    window, block, P = 1024, 128, 2048
    for bad in ([0, 15, 1, 1], [1, 7, 0, 2], [0, 0, -1, 2], [-1, 0, 1, 0]):
        st = torch.tensor([[0, 0, 2, 1], bad], dtype=torch.int32)
        assert pool.pool_plan(st, window, block, P).n_work.item() == -1
    st = torch.tensor([[0, 0, 8, 8]] * 5, dtype=torch.int32)
    plan = pool.pool_plan(st, window, block, P, span=1)
    assert plan.first[-1] > plan.work.shape[0]
    assert plan.n_work.item() == -1


# ------------------------------------------------------------------- K3
TILES_CASES = [
    # (Sm, Sp, m2p counts, p2p counts): 0, the whole row, not multiples
    (300, 1000, [0, 300, 129, 1], [1000, 0, 257, 128]),
    (128, 64, [128, 0, 5], [64, 64, 0]),
    (1, 2000, [1, 0], [1999, 2000]),
]


@pytest.mark.parametrize("span", [1, 4, tiles.SPAN])
@pytest.mark.parametrize("case", range(len(TILES_CASES)))
def test_tiles_plan_matches_a_brute_force(case, span):
    Sm, Sp, mc, pc = TILES_CASES[case]
    C = len(mc)
    want = [-(-min(max(m, 0), Sm) // GR) + -(-min(max(p, 0), Sp) // GR)
            for m, p in zip(mc, pc)]
    cap = tiles.tiles_capacity(C, Sm, Sp, span)
    plan = tiles.tiles_plan(C, Sm, Sp, torch.tensor(mc), torch.tensor(pc),
                            span)
    assert_plan(plan, want, span, cap)
    whole = [-(-Sm // GR) + -(-Sp // GR)] * C
    assert_plan(tiles.tiles_plan(C, Sm, Sp, span=span), whole, span, cap)


@pytest.mark.parametrize("span", [1, 2, 5])
def test_spans_cut_each_tiles_granules_in_order(span):
    """Expanding the work list: span s of tile work[s] holds the granules
    [(s - first[g]) * span, ...) of its tile; over the live spans every
    tile gets exactly its granules 0, 1, ..., in order, each once."""
    window, block, P, sched = POOL_CASES[1]
    st = torch.tensor(sched, dtype=torch.int32)
    counts = pool.pool_granules(st, window, block, P).tolist()
    tplan = tiles.tiles_plan(4, 300, 1000, torch.tensor([0, 300, 129, 1]),
                             torch.tensor([1000, 0, 257, 128]), span)
    tcounts = [8, 3, 5, 2]
    for plan, cnt in ((pool.pool_plan(st, window, block, P, span), counts),
                      (tplan, tcounts)):
        got = [[] for _ in cnt]
        first = plan.first.tolist()
        for s, g in enumerate(plan.work[:plan.n_work.item()].tolist()):
            z = s - first[g]
            assert first[g] <= s < first[g + 1]
            got[g].extend(range(z * span, min((z + 1) * span, cnt[g])))
        assert got == [list(range(k)) for k in cnt]
        assert (plan.work[plan.n_work.item():] == len(cnt)).all()


# ------------------------------------------------------- plain versions
def make_pool(rng, sched, window, block, T, ndim=3, n=1000):
    """A pool of two windows: node blocks (second moments, index -1) then
    particle blocks, the last rows of each segment padding (mass 0 at a
    4*box sentinel), self pairs at the head of each particle segment and a
    node row on target 2 of tile 0; the last 3 targets of each tile are
    padding (index n)."""
    G, P = len(sched), 2 * window
    tpos = rng.standard_normal((G, T, ndim)).astype(np.float32)
    tidx = rng.choice(n, size=(G, T), replace=False).astype(np.int64)
    tidx[:, -3:] = n
    ppos = np.full((P, ndim), 40.0, np.float32)
    pmass = np.zeros(P, np.float32)
    pidx = np.full(P, -1, np.int64)
    Q = ndim * (ndim + 1) // 2
    pquad = np.zeros((P, Q), np.float32)
    for g, (w, s, m, p) in enumerate(sched):
        r0 = (w * (window // block) + s) * block
        for seg, nb in ((0, m), (1, p)):
            rws = np.arange(r0, r0 + nb * block)[:max(0, nb * block - 5)]
            r0 += nb * block
            ppos[rws] = 1.5 * rng.standard_normal((len(rws), ndim))
            pmass[rws] = rng.uniform(0.1, 1, len(rws))
            if seg == 0:
                d = rng.standard_normal((len(rws), ndim)) * 0.1
                pquad[rws] = np.stack([d[:, a] * d[:, b] for a, b in
                                       shared.quad_pairs(ndim)], 1) \
                    * pmass[rws, None]
            elif len(rws) > 4:
                pidx[rws] = rng.choice(n, len(rws), replace=False)
                pidx[rws[:3]] = tidx[g, :3]
                ppos[rws[:3]] = tpos[g, :3]
    w, s, m, _ = sched[0]
    if m:
        ppos[(w * (window // block) + s) * block + 1] = tpos[0, 2]
    return tpos, tidx, ppos, pmass, pidx, np.asarray(sched, np.int32), pquad


def _t(a):
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i" else a)


def _j(a):
    return jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# (granule, span): other granules, one span a granule, a whole tile
PLANS = [(32, 1), (64, 3), (GR, 0)]


@pytest.mark.parametrize("granule,span", PLANS)
@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("comp", [False, True])
def test_plain_pool_at_other_plans_matches_pallas(comp, quad, granule, span):
    """Blocks of 200 rows (ragged granules), ragged T, every mode, eps 0
    (the node on a target) and 0.01; a 2-D pool at one of the plans."""
    window, block = 800, 200
    sched = [[0, 0, 1, 2], [0, 3, 0, 1], [1, 0, 2, 1], [0, 0, 0, 0],
             [1, 3, 1, 0]]
    for ndim in (3, 2) if granule == 64 else (3,):
        case = make_pool(np.random.default_rng(granule + span), sched,
                         window, block, T=37, ndim=ndim)
        t, j = [_t(a) for a in case], [_j(a) for a in case]
        for mode in MODES:
            for eps in (0.0, 0.01):
                kw = dict(compensated=comp, mode=mode)
                got = pool.eval_pool_plain(
                    *t[:6], window, shared.scalar_buffer(eps, 1.5, t[0]),
                    block, pool_quad=t[6] if quad else None, granule=granule,
                    span=span, **kw)
                want = pk.eval_pool(*j[:6], window, eps, 1.5, block,
                                    pool_quad=j[6] if quad else None,
                                    interpret=True, **kw)
                assert all(bool(torch.isfinite(x).all()) for x in got)
                _close(got, want)
                assert not got[0][3].any() and not got[1][3].any()


@pytest.mark.parametrize("granule,span", PLANS + [(GR, pool.SPAN)])
def test_compensated_plain_pool_is_closer_to_float64_at_every_plan(granule,
                                                                   span):
    """test_torch_pool.py's cancellation-heavy segment (32 blocks of 128,
    masses over seven decades) at other granules and span lengths: TwoSum
    at both levels lands closer to the float64 sum than fp32 sums."""
    rng = np.random.default_rng(8)
    nb, block = 32, 128
    P = nb * block
    tpos = (rng.standard_normal((1, 8, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((P, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (P, 1))
    mass = rng.uniform(1e-6, 10.0, P)
    case = [torch.as_tensor(a) for a in (
        tpos, np.arange(8)[None], src.astype(np.float32),
        mass.astype(np.float32), np.full(P, -1), np.array([[0, 0, 0, nb]]))]
    d = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(d, axis=-1)).sum(-1)
    errs = {}
    for comp in (False, True):
        _, p = pool.eval_pool_plain(
            *case, P, shared.scalar_buffer(0.0, 1.0, case[0]), block,
            compensated=comp, mode="pot", granule=granule, span=span)
        errs[comp] = np.abs(p.numpy().astype(np.float64) - pot_ref).max()
    assert errs[True] < errs[False]


def make_tiles(rng, C, T, Sm, Sp, mc, pc, ndim=3, n=1000):
    """Rows for K3 with these counts: padding past them at 1e30 (M2P) and
    at a 4*box sentinel (P2P), mass 0, index -1; self pairs at the head of
    the P2P rows; node 1 of tile 0 on target 2; the last 3 targets
    padding (index n)."""
    tpos = rng.standard_normal((C, T, ndim)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    tidx[:, -3:] = n
    mpos = (3 * rng.standard_normal((C, Sm, ndim))).astype(np.float32)
    mmass = rng.uniform(0.1, 1, (C, Sm)).astype(np.float32)
    ppos = rng.standard_normal((C, Sp, ndim)).astype(np.float32)
    pmass = rng.uniform(0.1, 1, (C, Sp)).astype(np.float32)
    pidx = rng.integers(0, n, (C, Sp)).astype(np.int64)
    ppos[:, :4] = tpos[:, :4]
    pidx[:, :4] = tidx[:, :4]
    mpos[0, 1] = tpos[0, 2]
    mc, pc = np.asarray(mc), np.asarray(pc)
    for pos, mass, cnt, idx, far in ((mpos, mmass, mc, None, 1e30),
                                     (ppos, pmass, pc, pidx, 40.0)):
        dead = np.arange(pos.shape[1])[None] >= cnt[:, None]
        pos[dead] = far
        mass[dead] = 0
        if idx is not None:
            idx[dead] = -1
    return tpos, tidx, mpos, mmass, mc, ppos, pmass, pidx, pc


@pytest.mark.parametrize("granule,span", PLANS)
@pytest.mark.parametrize("ndim", [3, 2])
def test_plain_tiles_at_other_plans_matches_pallas(ndim, granule, span):
    """Counts of 0, of the whole row and not multiples of the granule,
    ragged T, eps 0 (the node on a target) and 0.05."""
    Sm, Sp = 300, 500
    mc, pc = [0, 300, 129, 77], [500, 0, 257, 3]
    case = make_tiles(np.random.default_rng(granule * 7 + span), 4, 45, Sm,
                      Sp, mc, pc, ndim)
    t, j = [_t(a) for a in case], [_j(a) for a in case]
    for eps in (0.0, 0.05):
        tp, ti, mp, mm, mcnt, pp, pm, pi, pcnt = t
        got = tiles.eval_tiles_plain(
            tp, ti, mp, mm, pp, pm, pi, shared.scalar_buffer(eps, 1.5, tp),
            m2p_cnt=mcnt, p2p_cnt=pcnt, granule=granule, span=span)
        tp, ti, mp, mm, mcnt, pp, pm, pi, pcnt = j
        want = pk.eval_tiles(tp, ti, mp, mm, None, pp, pm, pi, eps, 1.5,
                             m2p_cnt=mcnt, p2p_cnt=pcnt, block=64,
                             interpret=True)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        _close(got, want)


# ------------------------------------------------------------------- K4
# (S, block, counts): 0 and a negative count (one block all the same), a
# count past S, the whole row, counts that end inside a block; block 64
# (not a multiple of the granule at the row's end), 1000 (cut to S) and
# 200 (granules cross its blocks)
PAIR_CASES = [
    (300, 64, [0, 400, -3, 300, 65]),
    (300, 1000, [0, 400, -3, 300, 65]),
    (1000, 200, [1, 999, 0, 129, 201]),
]


def brute_visited(S, block, k):
    """Entries of a row of S that the reference's _pairwise visits for a
    tile with count k: whole blocks of min(block, S) up to max(min(k, S),
    1), the last one cut at S."""
    b = min(block, S)
    k = max(min(max(k, 0), S), 1)
    return min(-(-k // b) * b, S)


@pytest.mark.parametrize("span", [1, 4, tiles.SPAN])
@pytest.mark.parametrize("case", range(len(PAIR_CASES)))
def test_pairwise_plan_matches_a_brute_force(case, span):
    S, block, cnt = PAIR_CASES[case]
    C = len(cnt)
    want = [-(-brute_visited(S, block, k) // GR) for k in cnt]
    cap = tiles.pairwise_capacity(C, S, span)
    plan = tiles.pairwise_plan(C, S, torch.tensor(cnt), block, span)
    assert_plan(plan, want, span, cap)
    assert tiles.pairwise_entries(C, S, torch.tensor(cnt), block).tolist() \
        == [brute_visited(S, block, k) for k in cnt]
    whole = [-(-S // GR)] * C
    assert_plan(tiles.pairwise_plan(C, S, None, block, span), whole, span,
                cap)


def make_pair_row(rng, C, T, S, n=1000):
    """One K4 row: particles with mass everywhere (past each count too),
    self pairs at the head of each tile's row, the last 3 targets padding
    (index n)."""
    tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    tidx[:, -3:] = n
    spos = rng.standard_normal((C, S, 3)).astype(np.float32)
    smass = rng.uniform(0.1, 1, (C, S)).astype(np.float32)
    sidx = rng.integers(0, n, (C, S)).astype(np.int64)
    spos[:, :4] = tpos[:, :4]
    sidx[:, :4] = tidx[:, :4]
    return tpos, tidx, spos, smass, sidx


@pytest.mark.parametrize("use_idx", [False, True])
@pytest.mark.parametrize("span", [1, 2, 5])
def test_plain_pairwise_at_every_span_matches_pallas(span, use_idx):
    """The plain K4 in its granules and spans against `pallas._pairwise`
    in interpret mode: the reference's visited set, the entries past a
    count inside a visited block included (they carry mass here, so a plan
    that stopped at the count would differ)."""
    S, T = 300, 40
    cnt = np.array([0, 400, -3, 300, 65, 130])
    case = make_pair_row(np.random.default_rng(span * 2 + use_idx), 6, T,
                         S)
    t = [_t(a) for a in case]
    j = [_j(a) for a in case]
    eps = 0.0 if use_idx else 0.05
    for block in (64, 1000):
        got = tiles.eval_pairwise_plain(
            *t, shared.scalar_buffer(eps, 1.0, t[0]), use_idx, cnt=_t(cnt),
            block=block, span=span)
        want = pk._pairwise(*j, eps, use_idx=use_idx, cnt=_j(cnt),
                            block=block, interpret=True)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        _close(got, want)
        # up to the counts only: another result
        live = np.arange(S)[None] < np.clip(cnt, 0, S)[:, None]
        cut = list(t)
        cut[3] = torch.as_tensor(np.where(live, case[3], np.float32(0)))
        short = tiles.eval_pairwise_plain(
            *cut, shared.scalar_buffer(eps, 1.0, cut[0]), use_idx, cnt=_t(cnt),
            block=block, span=span)
        assert float((short[1] - got[1]).abs().max()) > 1e-2
