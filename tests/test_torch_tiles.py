"""rakau_tpu_torch.kernels.tiles against rakau_tpu.kernels: the plain
versions of K3 (fused) and K4 (split, one launch a row) against
`pallas.eval_tiles(interpret=True, fused=True/False)`, the ports of the
plain-op route against `xla.eval_m2p` / `xla.eval_p2p` (with and without
the quadrupole), in 3-D and 2-D, at the reference's kernel tolerance
(rtol 2e-4, atol 2e-5); the block plan's edge cases (counts of 0 and of
the whole row, a node on a target at eps = 0); dispatch.eval_tiles'
routes; and the 2-D padding that every CUDA wrapper applies: the 3-D
plain versions of K1 (every form), K2 and K3 on padded operands equal
their 2-D plain versions, and the wrappers' checks take 2-D and float64
operands and refuse the rest."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu.kernels import pallas as pk
from rakau_tpu.kernels import xla as xk
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, pool, shared, tiles

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


def make_case(rng, C=3, T=32, Sm=96, Sp=64, n=1000, ndim=3):
    """tests/test_pallas.py:make_case: per-tile rows with padded tails
    (mass 0 at 1e30, index -1) after random counts, and self pairs planted
    at the head of the P2P row."""
    tgt_pos = rng.standard_normal((C, T, ndim)).astype(np.float32)
    tgt_idx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
    m_pos = (rng.standard_normal((C, Sm, ndim)) * 3).astype(np.float32)
    m_mass = rng.uniform(0.1, 1, (C, Sm)).astype(np.float32)
    m_cnt = rng.integers(Sm // 2, Sm, C).astype(np.int64)
    mvalid = np.arange(Sm)[None, :] < m_cnt[:, None]
    m_pos = np.where(mvalid[..., None], m_pos, np.float32(1e30))
    m_mass = np.where(mvalid, m_mass, np.float32(0))
    p_pos = rng.standard_normal((C, Sp, ndim)).astype(np.float32)
    p_mass = rng.uniform(0.1, 1, (C, Sp)).astype(np.float32)
    p_idx = rng.integers(0, n, (C, Sp)).astype(np.int64)
    p_cnt = rng.integers(Sp // 2, Sp, C).astype(np.int64)
    pvalid = np.arange(Sp)[None, :] < p_cnt[:, None]
    p_pos = np.where(pvalid[..., None], p_pos, np.float32(1e30))
    p_mass = np.where(pvalid, p_mass, np.float32(0))
    p_idx = np.where(pvalid, p_idx, -1)
    p_pos[:, :8] = tgt_pos[:, :8]
    p_idx[:, :8] = tgt_idx[:, :8]
    return (tgt_pos, tgt_idx, m_pos, m_mass, m_cnt, p_pos, p_mass, p_idx,
            p_cnt)


def _t(case):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in case]


def _j(case):
    return [jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
            for a in case]


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


def _port(case, eps, fused, block=32, G=1.0):
    tp, ti, mp, mm, mc, pp, pm, pi, pc = _t(case)
    return tiles.eval_tiles(tp, ti, mp, mm, None, pp, pm, pi, eps, G,
                            m2p_cnt=mc, p2p_cnt=pc, block=block, fused=fused)


def _pallas(case, eps, fused, block=32, G=1.0):
    tp, ti, mp, mm, mc, pp, pm, pi, pc = _j(case)
    return pk.eval_tiles(tp, ti, mp, mm, None, pp, pm, pi, eps, G,
                         m2p_cnt=mc, p2p_cnt=pc, block=block,
                         interpret=True, fused=fused)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_plain_matches_pallas_interpret(eps, fused):
    case = make_case(np.random.default_rng(42))
    _close(_port(case, eps, fused, G=1.5), _pallas(case, eps, fused, G=1.5))


def test_plain_2d_matches_pallas_interpret():
    case = make_case(np.random.default_rng(5), ndim=2)
    _close(_port(case, 0.01, True), _pallas(case, 0.01, True))
    _close(_port(case, 0.01, False), _pallas(case, 0.01, False))


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("quad", [False, True])
def test_xla_route_ports_match_xla(quad, ndim):
    rng = np.random.default_rng(9)
    tp, ti, mp, mm, _, pp, pm, pi, _ = make_case(rng, ndim=ndim)
    q = None
    if quad:
        Q = ndim * (ndim + 1) // 2
        q = (rng.standard_normal(mm.shape + (Q,)) * 0.01
             * mm[..., None]).astype(np.float32)
    got = tiles.eval_m2p(*_t((tp, mp, mm)), 0.02, 1.5,
                         src_quad=None if q is None else torch.as_tensor(q))
    want = xk.eval_m2p(*_j((tp, mp, mm)), 0.02, 1.5,
                       src_quad=None if q is None else jnp.asarray(q))
    _close(got, want)
    _close(tiles.eval_p2p(*_t((tp, ti, pp, pm, pi)), 0.02, 1.5),
           xk.eval_p2p(*_j((tp, ti, pp, pm, pi)), 0.02, 1.5))


def test_fused_plain_is_the_xla_sum_with_counts_at_the_edges():
    """Counts of 0 and of the whole row, and a count that ends inside a
    block: K3's plain version, K4's and the plain-op route agree (the
    rows past the count are padding)."""
    rng = np.random.default_rng(13)
    case = list(make_case(rng, C=4, Sm=100, Sp=70))
    case[4] = np.array([0, 100, 37, 64])           # m2p counts
    case[8] = np.array([70, 0, 33, 8])             # p2p counts
    for k, (pos, mass, cnt) in enumerate(((2, 3, 4), (5, 6, 8))):
        live = np.arange(case[pos].shape[1])[None] < case[cnt][:, None]
        case[pos] = np.where(live[..., None], case[pos], np.float32(1e30))
        case[mass] = np.where(live, case[mass], np.float32(0))
    tp, ti, mp, mm, _, pp, pm, pi, _ = _t(case)
    am, pmt = tiles.eval_m2p(tp, mp, mm, 0.0, 1.0)
    ap, ppt = tiles.eval_p2p(tp, ti, pp, pm, pi, 0.0, 1.0)
    want = (am + ap, pmt + ppt)
    for fused in (True, False):
        for block in (16, 32, 1024):
            got = _port(case, 0.0, fused, block=block)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    # a tile whose rows both have count 0 gets exact zeros from K3
    case[4][1] = 0
    got = _port(case, 0.0, True)
    assert not got[0][1].any() and not got[1][1].any()


def test_node_on_a_target_at_zero_softening_adds_nothing():
    """The M2P row has no indices: a node exactly on a target is dead by
    r2 <= 0 alone, in K3's and K4's plain versions."""
    case = list(make_case(np.random.default_rng(17)))
    case[2][0, 3] = case[0][0, 5]                  # node 3 on target 5
    for fused in (True, False):
        got = _port(case, 0.0, fused)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        off = [c.copy() for c in case]
        off[3][0, 3] = 0.0
        bare = _port(off, 0.0, fused)
        torch.testing.assert_close(got[0][0, 5], bare[0][0, 5], rtol=1e-6,
                                   atol=1e-6)


def test_tile_blocks_is_the_reference_plan():
    cnt = torch.tensor([0, 1, 32, 33, 200, -4])
    assert tiles.tile_blocks(cnt, 96, 32, False).tolist() == [0, 1, 1, 2, 3,
                                                               0]
    assert tiles.tile_blocks(cnt, 96, 32, True).tolist() == [1, 1, 1, 2, 3, 1]
    assert tiles.tile_blocks(None, 96, 32, True) == 3


def test_dispatch_routes():
    """Monopole CPU tensors to the plain K3 (K4 inside
    tiles_variant("split")), the quadrupole to the plain-op route,
    counted as "xla_quad"."""
    case = make_case(np.random.default_rng(23))
    tp, ti, mp, mm, mc, pp, pm, pi, pc = _t(case)
    cfg = TreeConfig()
    tiles.reset_launches()
    got = dispatch.eval_tiles(cfg, tp, ti, mp, mm, None, pp, pm, pi, 0.0,
                              1.0, m2p_cnt=mc, p2p_cnt=pc)
    _close(got, tiles.eval_tiles_plain(tp, ti, mp, mm, pp, pm, pi, 0.0,
                                       1.0, m2p_cnt=mc, p2p_cnt=pc))
    with dispatch.tiles_variant("split"):
        split = dispatch.eval_tiles(cfg, tp, ti, mp, mm, None, pp, pm, pi,
                                    0.0, 1.0, m2p_cnt=mc, p2p_cnt=pc)
    _close(split, got)
    q = torch.zeros(mm.shape + (6,))
    quad = dispatch.eval_tiles(cfg, tp, ti, mp, mm, q, pp, pm, pi, 0.0, 1.0)
    _close(quad, got)
    assert tiles.launches["xla_quad"] == 1
    assert tiles.launches["fused"] == tiles.launches["split"] == 0
    with pytest.raises(NotImplementedError):
        tiles.eval_tiles(tp, ti, mp, mm, q, pp, pm, pi, 0.0, 1.0)
    with pytest.raises(ValueError):
        with dispatch.tiles_variant("mma"):
            pass


# ------------------------------------------------ F1: 2-D padded to 3-D
def _pad(*ts, quad=None):
    return shared.pad_to_3d(*ts, quad=quad)


def test_padding_is_exact_for_k3_and_k4():
    case = _t(make_case(np.random.default_rng(29), ndim=2))
    tp, ti, mp, mm, mc, pp, pm, pi, pc = case
    (tp3, mp3, pp3), _ = _pad(tp, mp, pp)
    for fused in (True, False):
        want = tiles.eval_tiles(tp, ti, mp, mm, None, pp, pm, pi, 0.01, 1.0,
                                m2p_cnt=mc, p2p_cnt=pc, block=32,
                                fused=fused)
        a3, p3 = tiles.eval_tiles(tp3, ti, mp3, mm, None, pp3, pm, pi, 0.01,
                                  1.0, m2p_cnt=mc, p2p_cnt=pc, block=32,
                                  fused=fused)
        assert not a3[..., 2].any()
        torch.testing.assert_close(a3[..., :2], want[0], rtol=0, atol=0)
        torch.testing.assert_close(p3, want[1], rtol=0, atol=0)


def _row2d(seed, C=3, T=40, S=700):
    rng = np.random.default_rng(seed)
    tpos = rng.standard_normal((C, T, 2)).astype(np.float32)
    tidx = rng.choice(5000, size=(C, T), replace=False).astype(np.int64)
    spos = (0.5 + rng.standard_normal((S, 2))).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = rng.integers(-1, 5000, S).astype(np.int64)
    spos[:6] = tpos[0, :6]
    sidx[:6] = tidx[0, :6]
    mask = rng.uniform(size=(C, S)) < 0.5
    d = rng.standard_normal((S, 2)) * 0.1
    quad = (np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(2)], 1)
            * smass[:, None]).astype(np.float32)
    tcell = rng.integers(0, 8, (C, T, 2))
    scell = rng.integers(0, 8, (S, 2))
    scell[30:40] = -1
    return ([torch.as_tensor(a) for a in (tpos, tidx, spos, smass, sidx,
                                          mask)],
            torch.as_tensor(quad), torch.as_tensor(scell),
            torch.as_tensor(tcell))


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("comp", [False, True])
def test_padding_is_exact_for_every_k1_form(comp, quad, cells):
    (tp, ti, sp, sm, si, mask), q, sc, tc = _row2d(31)
    kw = dict(compensated=comp, block=256)
    kw3 = dict(kw)
    (tp3, sp3, sc3, tc3), q3 = _pad(tp, sp, sc, tc, quad=q)
    if quad:
        kw["src_quad"], kw3["src_quad"] = q, q3
    if cells:
        kw.update(src_cell=sc, tgt_cell=tc, grid_sep=2)
        kw3.update(src_cell=sc3, tgt_cell=tc3, grid_sep=2)
    for mode in ("both", "acc", "pot"):
        want = shared.eval_shared_plain(tp, ti, sp, sm, si, mask, 0.01, 1.5,
                                        mode=mode, **kw)
        a3, p3 = shared.eval_shared_plain(tp3, ti, sp3, sm, si, mask, 0.01,
                                          1.5, mode=mode, **kw3)
        assert not a3[..., 2].any()
        torch.testing.assert_close(a3[..., :2], want[0], rtol=0, atol=0)
        torch.testing.assert_close(p3, want[1], rtol=0, atol=0)


def test_padding_is_exact_for_k2_k5_and_k6():
    (tp, ti, sp, sm, si, mask), q, sc, tc = _row2d(37, S=512)
    (tp3, sp3, sc3, tc3), q3 = _pad(tp, sp, sc, tc, quad=q)
    for fn, kw in ((shared.eval_shared_blocks_plain, dict(span=1)),
                   (shared.eval_shared_mma_plain, dict(prec="highest"))):
        want = fn(tp, ti, sp, sm, si, mask, 0.05, 1.0, **kw)
        got = fn(tp3, ti, sp3, sm, si, mask, 0.05, 1.0, **kw)
        torch.testing.assert_close(got[0][..., :2], want[0], rtol=0,
                                   atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    # K2: three tiles of one pool window, node blocks then particle blocks
    block, window = 128, 512
    sched = torch.tensor([[0, 0, 1, 2], [0, 1, 0, 3], [0, 0, 0, 0]])
    for comp in (False, True):
        for quad in (None, q):
            kw = dict(compensated=comp, pool_quad=quad)
            want = pool.eval_pool_plain(tp, ti, sp, sm, si, sched, window,
                                        0.0, 1.0, block, **kw)
            kw["pool_quad"] = None if quad is None else q3
            got = pool.eval_pool_plain(tp3, ti, sp3, sm, si, sched, window,
                                       0.0, 1.0, block, **kw)
            torch.testing.assert_close(got[0][..., :2], want[0], rtol=0,
                                       atol=0)
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


def test_wrappers_take_2d_and_float64_and_refuse_the_rest():
    """The CUDA wrappers' checks pass 2-D and float64 operands on to the
    device check (CPU tensors: "must be a CUDA tensor"); other dimensions
    and types raise before it; K6 and K5 have no float64 build."""
    (tp, ti, sp, sm, si, mask), q, sc, tc = _row2d(41, S=256)
    case = _t(make_case(np.random.default_rng(43), ndim=2))
    tp2, ti2, mp2, mm2, mc2, pp2, pm2, pi2, pc2 = case
    sched = torch.zeros((tp.shape[0], 4), dtype=torch.int64)

    def calls(dt, ndim):
        def pos(x):
            x = x.to(dt)
            return torch.nn.functional.pad(x, (0, ndim - 2)) if ndim > 2 \
                else x[..., :ndim]
        return {
            "k1": lambda: shared.eval_shared_fused(
                pos(tp), ti, pos(sp), sm.to(dt), si, mask, 0.0, 1.0),
            "k2": lambda: pool.eval_pool_fused(
                pos(tp), ti, pos(sp), sm.to(dt), si, sched, 256, 0.0, 1.0,
                128),
            "k3": lambda: tiles.eval_tiles_fused(
                pos(tp2), ti2, pos(mp2), mm2.to(dt), pos(pp2), pm2.to(dt),
                pi2, 0.0, 1.0, m2p_cnt=mc2, p2p_cnt=pc2),
            "k4": lambda: tiles.eval_pairwise(
                pos(tp2), ti2, pos(pp2), pm2.to(dt), pi2, 0.0, True,
                cnt=pc2),
            "k6": lambda: shared.eval_shared_mma(
                pos(tp), ti, pos(sp), sm.to(dt), si, mask, 0.0, 1.0),
            "k5": lambda: shared.eval_shared_blocks(
                pos(tp), ti, pos(sp), sm.to(dt), si, mask, 0.0, 1.0),
        }

    for dt in (torch.float32, torch.float64):
        for ndim in (2, 3):
            for name, call in calls(dt, ndim).items():
                if dt == torch.float64 and name in ("k6", "k5"):
                    with pytest.raises(ValueError, match="float32 only"):
                        call()
                    continue
                with pytest.raises(ValueError, match="CUDA tensor"):
                    call()
    for name, call in calls(torch.float32, 4).items():
        with pytest.raises(NotImplementedError, match="2-D or 3-D"):
            call()
    for name, call in calls(torch.float16, 3).items():
        with pytest.raises(TypeError):
            call()
