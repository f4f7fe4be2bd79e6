"""rakau_tpu_torch.parallel.let, the LET domain decomposition, on CPU
shards. Held to rakau_tpu stage by stage: the derived export and query
configs (tests/test_product_modes.py:47-79), phase 0's routing (each
row's owner, the run counts and the exchange-overflow flag exactly equal
to a NumPy transcription of rakau_tpu/parallel/let.py:192-214 on the
reference's (hi, lo) Morton words) and one shard's export walk (the
compacted export rows and counts exactly equal to
rakau_tpu.traversal2.build_shared_sources with the domain boxes as tiles).
The whole pipeline is held to the float64 direct sum and to the port's
single-device query with the envelopes of tests/test_let.py (at smaller
N); the whole-pipeline comparison with the reference's acc_pot_let runs
under `slow`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import morton as jmorton
from rakau_tpu import particles as jparticles
from rakau_tpu import scan_utils as jsu
from rakau_tpu import traversal2 as jt2
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.parallel import let as jlet
from rakau_tpu_torch import build, engine
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np
from rakau_tpu_torch.parallel import let, sharded

from .helpers import rel_vec_err, rms

torch.set_num_threads(1)

# tests/test_let.py's CFG, with the particle row cut to 8192 (N <= 4096)
CFG_KW = dict(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=16,
              m2p_cap=2048, p2p_leaf_cap=2048, p2p_src_cap=8192,
              frontier_cap=1024)
CFG = TreeConfig(**CFG_KW)
# export slots a destination: above the largest count these cases export
# (1023 at 2 shards, 379 at 8); each shard's query sees ndev times as
# many import rows
EXPORT_CAP = {2: 2048, 8: 512}


def _plummer(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


def _mesh(ndev):
    return sharded.default_mesh(ndev, device="cpu")


# ---- the derived configs ------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(farfield="grid"),
    dict(farfield="m2p", multipole_order=2),
    dict(traversal_mode="lmac", farfield="grid2", multipole_order=2),
    dict(traversal_mode="lmac", farfield="grid2", multipole_order=2,
         local_order=6, accum="compensated"),
    dict(max_depth=6, max_leaf_n=16, ncrit=32, tile_chunk=8, m2p_cap=512,
         p2p_leaf_cap=256, p2p_src_cap=2048, frontier_cap=512),
    dict(max_depth=6, max_leaf_n=16, ncrit=32, tile_chunk=8, m2p_cap=512,
         p2p_leaf_cap=256, p2p_src_cap=2048, traversal_mode="lmac",
         farfield="m2p", multipole_order=2, frontier_cap=4096),
])
def test_internal_cfgs_match_the_reference(cfg_kw):
    jc = JaxConfig(**cfg_kw)
    pc = TreeConfig(**cfg_kw)
    for caps in ((512, 2048, 256, 512), (8192, 32768, 4096, 1024)):
        assert (dataclasses.asdict(let._export_cfg(pc, *caps))
                == dataclasses.asdict(config_from_jax(
                    jlet._export_cfg(jc, *caps))))
    assert (dataclasses.asdict(let._query_cfg(pc))
            == dataclasses.asdict(config_from_jax(jlet._query_cfg(jc))))


def test_query_cfg_mapping():
    assert let._query_cfg(TreeConfig(farfield="grid")).farfield == "local"
    q = let._query_cfg(TreeConfig(traversal_mode="lmac", farfield="grid2",
                                  multipole_order=2))
    assert q.farfield == "m2p" and q.multipole_order == 2
    e = let._export_cfg(TreeConfig(farfield="m2p", multipole_order=2),
                        512, 2048, 256, 512)
    assert e.multipole_order == 0 and e.farfield == "local"


# ---- phase 0 ------------------------------------------------------------

def _route_np(hi_s, lo_s, nl, cap, s_smp):
    """rakau_tpu/parallel/let.py:192-214 in NumPy, on each shard's sorted
    (hi, lo) words."""
    ndev = len(hi_s)
    sidx = (np.arange(s_smp) * nl) // s_smp + nl // (2 * s_smp)
    smp_hi = np.concatenate([h[sidx] for h in hi_s])
    smp_lo = np.concatenate([lo[sidx] for lo in lo_s])
    order = np.lexsort((smp_lo, smp_hi))
    ranks = np.arange(1, ndev) * s_smp
    sp_hi, sp_lo = smp_hi[order][ranks], smp_lo[order][ranks]
    out = []
    for me in range(ndev):
        hi, lo = hi_s[me], lo_s[me]
        ge = (hi[:, None] > sp_hi[None, :]) | (
            (hi[:, None] == sp_hi[None, :]) & (lo[:, None] >= sp_lo[None, :]))
        dest = ge.sum(1)
        start = np.searchsorted(dest, np.arange(ndev), side="left")
        cnt = np.concatenate([start[1:], [nl]]) - start
        x_ovf = bool(np.any((cnt > cap) & (np.arange(ndev) != me)))
        out.append((dest, cnt, x_ovf))
    return out


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("slack", [2.0, 1.0])
def test_phase0_routing_matches_the_reference(ndev, slack):
    n, depth, box = 4096, 8, 32.0
    pos, _ = _plummer(n, 3 + ndev)
    if slack == 1.0:
        # clustered: most rows belong to few shards, foreign runs overflow
        pos = np.where(np.arange(n)[:, None] % 3 == 0, pos,
                       0.02 * pos + 5.0).astype(np.float32)
    nl = n // ndev
    cap = max(1, -(-int(nl * slack) // ndev))
    s_smp = min(128, nl)
    codes, hi_s, lo_s = [], [], []
    for r in range(ndev):
        p = pos[r * nl:(r + 1) * nl]
        cells = jparticles.discretize(jnp.asarray(p), box, depth)
        hi, lo = (np.asarray(w) for w in jmorton.encode(cells, 3, depth))
        order = np.lexsort((lo, hi))
        hi_s.append(hi[order])
        lo_s.append(lo[order])
        codes.append(let._sort_sample(
            torch.tensor(p), torch.ones(nl), torch.tensor(box), depth,
            s_smp))
    np.testing.assert_array_equal(
        np.concatenate([c[0].numpy() for c in codes]),
        np.concatenate([(h.astype(np.int64) << 32) | lo.astype(np.int64)
                        for h, lo in zip(hi_s, lo_s)]))
    smp = torch.stack([c[4] for c in codes])
    got = [let._route_rows(me, c[0], c[2], c[3], smp, torch.tensor(box), cap,
                           s_smp) for me, c in enumerate(codes)]
    want = _route_np(hi_s, lo_s, nl, cap, s_smp)
    for (dest, start, x_ovf, _, _), (d_w, c_w, x_w) in zip(got, want):
        np.testing.assert_array_equal(dest.numpy(), d_w)
        np.testing.assert_array_equal(
            torch.diff(start, append=start.new_full((1,), nl)).numpy(), c_w)
        assert bool(x_ovf) == x_w
    assert any(x for _, _, x in want) == (slack == 1.0)


# ---- one shard's export walk -------------------------------------------

def test_export_walk_matches_the_reference():
    pos, mass = _plummer(2048, 41)
    box = 32.0
    mine = pos[:, 0] < 0                       # this shard: x < 0
    jc = JaxConfig(**CFG_KW)
    jtd = jax.jit(jbuild.build_tree, static_argnames=("cfg",))(
        jnp.asarray(pos[mine]), jnp.asarray(mass[mine]), jc,
        box_size=jnp.float32(box))
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    # four domains (the half-spaces' quadrants); this shard is domain 0
    quads = [(pos[:, 0] < 0) & (pos[:, 1] < 0), (pos[:, 0] < 0)
             & (pos[:, 1] >= 0), (pos[:, 0] >= 0) & (pos[:, 1] < 0),
             (pos[:, 0] >= 0) & (pos[:, 1] >= 0)]
    dlo = np.stack([pos[q].min(0) for q in quads])
    dhi = np.stack([pos[q].max(0) for q in quads])
    not_me = np.array([False, False, True, True])   # 1 is mine as well
    caps, cap, theta = (512, 4096, 512, 256), 1024, 0.6
    jce = jlet._export_cfg(jc, *caps)
    src = jax.jit(jt2.build_shared_sources, static_argnames=("cfg",))(
        jtd, jce, jnp.float32(theta), jnp.asarray(dlo), jnp.asarray(dhi),
        tile_valid=jnp.asarray(not_me))
    idxs, cnt_j = jsu.compact_indices(src.mask, cap)
    S = src.pos.shape[0]
    valid = np.asarray(idxs) < S
    safe = np.clip(np.asarray(idxs), 0, S - 1)
    pos_j = np.where(valid[..., None], np.asarray(src.pos)[safe],
                     np.float32(4.0) * np.float32(box))
    mass_j = np.where(valid, np.asarray(src.mass)[safe], 0.0)
    ovf_j = bool(np.any(np.asarray(cnt_j) > cap)
                 or np.asarray(src.overflow).any())

    e_pos, e_mass, cnt, ovf = let._export_rows(
        td, let._export_cfg(config_from_jax(jc), *caps), theta,
        torch.tensor(dlo), torch.tensor(dhi), torch.tensor(not_me), cap,
        torch.tensor(box))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(e_pos.numpy(), pos_j)
    np.testing.assert_array_equal(e_mass.numpy(), mass_j)
    assert not ovf and not ovf_j
    assert cnt[2] > 0 and cnt[3] > 0 and cnt[0] == cnt[1] == 0


# ---- the whole pipeline (port only) --------------------------------------

def _single_chip(pos, mass, theta, eps):
    td = build.build_tree(pos, mass, CFG)
    acc, pot, ovf, _ = engine.acc_pot_u_host(td, CFG, theta, eps)
    assert not ovf.any()
    return acc[td.inv_perm].numpy(), pot[td.inv_perm].numpy()


@pytest.mark.parametrize("ndev", [2, 8])
def test_let_matches_envelope(ndev):
    pos, mass = _plummer(2048, 31)
    theta, eps = 0.6, 0.01
    acc, pot, ovf, exp_ovf = let.acc_pot_let(
        torch.tensor(pos), torch.tensor(mass), CFG, theta, eps, 1.0,
        _mesh(ndev), export_cap=EXPORT_CAP[ndev])
    assert not ovf.any() and not exp_ovf
    acc_d, pot_d = direct_acc_pot_np(pos, mass, eps=eps)
    acc_1, _ = _single_chip(torch.tensor(pos), torch.tensor(mass), theta,
                            eps)
    e_let = rms(rel_vec_err(acc.numpy(), acc_d))
    e_one = rms(rel_vec_err(acc_1, acc_d))
    assert e_let < max(1.5 * e_one, 2e-3), (ndev, e_let, e_one)
    assert rms((pot.numpy() - pot_d) / pot_d) < 5e-3


def test_let_uneven_n():
    n = 1501                                   # not a multiple of 8
    rng = np.random.default_rng(33)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    acc, pot, ovf, exp_ovf = let.acc_pot_let(
        torch.tensor(pos), torch.tensor(mass), CFG, 0.6, 0.02, 1.0,
        _mesh(8), export_cap=EXPORT_CAP[8])
    assert not ovf.any() and not exp_ovf
    assert acc.shape == (n, 3) and pot.shape == (n,)
    acc_d, _ = direct_acc_pot_np(pos, mass, eps=0.02)
    assert rms(rel_vec_err(acc.numpy(), acc_d)) < 1e-2


def test_let_phase0_distributed_matches_global():
    pos, mass = _plummer(2048, 7)
    theta, eps = 0.6, 0.01
    out = {}
    for phase0 in ("distributed", "global"):
        a, p, ovf, xo, cnt = let.acc_pot_let(
            torch.tensor(pos), torch.tensor(mass), CFG, theta, eps, 1.0,
            _mesh(8), export_cap=EXPORT_CAP[8], phase0=phase0,
            with_stats=True)
        assert not ovf.any() and not xo
        assert cnt.shape == (8, 8) and not cnt.diagonal().any()
        out[phase0] = a.numpy()
    acc_d, _ = direct_acc_pot_np(pos, mass, eps=eps)
    e_dist = rms(rel_vec_err(out["distributed"], acc_d))
    e_glob = rms(rel_vec_err(out["global"], acc_d))
    assert e_dist < max(1.5 * e_glob, 2e-3), (e_dist, e_glob)
    assert rms(rel_vec_err(out["distributed"], out["global"])) < 3e-3


def test_let_exchange_overflow_flag():
    """All particles in one corner of the box: nearly every row routes to
    one shard, which slack 1.0 cannot hold (flagged, not truncated);
    slack 8.0 can, and the result is sound."""
    n = 1024
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.48, 0.49, size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    args = (torch.tensor(pos), torch.tensor(mass), CFG, 0.6, 0.02, 1.0,
            _mesh(8))
    kw = dict(export_cap=EXPORT_CAP[8], box_size=2.0)
    assert let.acc_pot_let(*args, exchange_slack=1.0, **kw)[3]
    acc, _, ovf, exp_ovf = let.acc_pot_let(*args, exchange_slack=8.0, **kw)
    assert not exp_ovf and not ovf.any()
    acc_o, _ = direct_acc_pot_np(pos.astype(np.float64),
                                 mass.astype(np.float64), eps=0.02)
    assert rms(rel_vec_err(acc.numpy(), acc_o)) < 1e-2


def test_dryrun_reproduces_the_reference_record():
    """__graft_entry__.dryrun_multichip's LET paths at its configuration
    (N=2048 from rakau_tpu.particles.plummer(PRNGKey(1)), 8 shards, box
    64): the port's deviations from its single-device engine, printed as
    the reference printed its own, equal MULTICHIP_r05.json's (shared +
    "local" and lmac + "m2p" + quadrupole)."""
    import json
    import os
    import re
    from rakau_tpu import particles as jp
    from rakau_tpu_torch import integrate
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    want = re.search(r"LET max rel dev (\S+), lmac\+m2p\+quad LET dev "
                     r"(\S+)\n", tail).groups()
    pos, mass = (torch.tensor(np.asarray(a))
                 for a in jp.plummer(jax.random.PRNGKey(1), 2048))
    cfg = TreeConfig(max_depth=6, max_leaf_n=16, ncrit=32, tile_chunk=8,
                     m2p_cap=512, p2p_leaf_cap=256, p2p_src_cap=2048,
                     frontier_cap=512)
    got = []
    for c in (cfg, cfg.with_(traversal_mode="lmac", farfield="m2p",
                             multipole_order=2, frontier_cap=4096)):
        acc_1, _, ovf_1 = integrate.acc_pot(pos, mass, c, 0.75, 0.05,
                                            box_size=64.0)
        acc, _, ovf, exp_ovf = let.acc_pot_let(
            pos, mass, c, 0.75, 0.05, 1.0, _mesh(8), box_size=64.0,
            export_cap=EXPORT_CAP[8])
        assert not ovf_1.any() and not ovf.any() and not exp_ovf
        dev = (acc - acc_1).norm(dim=1).max() / acc_1.norm(dim=1).max()
        got.append(f"{float(dev):.3e}")
    assert tuple(got) == want


# ---- the whole pipeline against the reference (slow) ---------------------

@pytest.mark.slow
@pytest.mark.parametrize("phase0", ["distributed", "global"])
def test_let_matches_the_reference_pipeline(phase0):
    from rakau_tpu.parallel import sharded as jsharded
    pos, mass = _plummer(2048, 13)
    jc = JaxConfig(**CFG_KW)
    theta, eps = 0.6, 0.01
    kw = dict(export_cap=EXPORT_CAP[2], box_size=32.0, phase0=phase0)
    out_j = jlet.acc_pot_let(
        jnp.asarray(pos), jnp.asarray(mass), jc, jnp.float32(theta),
        jnp.float32(eps), 1.0, jsharded.default_mesh(2),
        with_stats=phase0 == "distributed", **kw)
    a, p, ovf, xo, cnt = let.acc_pot_let(
        torch.tensor(pos), torch.tensor(mass), config_from_jax(jc), theta,
        eps, 1.0, _mesh(2), with_stats=True, **kw)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(out_j[2]))
    assert bool(xo) == bool(out_j[3])
    if phase0 == "distributed":
        # the reference's global path returns no counts
        np.testing.assert_array_equal(cnt.numpy(),
                                      np.asarray(out_j[4]).reshape(2, 2))
    assert rms(rel_vec_err(a.numpy(), np.asarray(out_j[0]))) <= 1e-5
    assert rms((p.numpy() - np.asarray(out_j[1]))
               / np.asarray(out_j[1])) <= 1e-5
