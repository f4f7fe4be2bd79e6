"""engine.acc_pot_u, the single-executable query of rakau_tpu_torch,
against jax.jit(rakau_tpu.engine.acc_pot_u) on the same JAX-built tree:
shared with "grid", "local" and "grid2", lmac + grid2, gwalk + grid at
tune_gwalk's caps, lists + m2p, the quadrupole with compensated sums,
modes "acc" and "pot", with_stats, imported sources (extra=) and a 2-D
tree. The overflow flags and maxima exactly equal, forces and potentials
within 1e-5 relative RMS (the port's other engine tests hold them so).
Then on the port alone: acc_pot_u's sums bit-equal to acc_pot_u_host's;
the chunk loop's slicing (slice_chunks 1, 3 and all, the last slice
moved back and evaluated whole) changing no sum, and no flag or maximum
but lmac's candidate-table slot; the query issuing no host read (what
would break a CUDA graph capture on the card); graph=True refused on CPU
tensors; graphs.GraphCache's key; the constant tables that the card's
captures read from the device equal to the ones built from NumPy."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import engine, graphs, grid, grid2, particles
from rakau_tpu_torch import traversal4
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, E = 2048, 256
THETA, EPS = 0.75, 0.01
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
            m2p_cap=2048, p2p_leaf_cap=1024, p2p_src_cap=8192,
            frontier_cap=1024)
# low order and a narrow stencil keep the reference's trace short
GRID2 = dict(farfield="grid2", grid_level=3, local_order=3, grid_sep=2)
GWALK = dict(traversal_mode="gwalk", m2p_cap=16384, p2p_leaf_cap=12288,
             p2p_src_cap=131072, frontier_cap=2048, pool_window=32768,
             pool_block=128, pool_group=2)
CASES = {
    "shared+grid": dict(farfield="grid", grid_level=3),
    "shared+local": dict(farfield="local"),
    "shared+grid2": GRID2,
    "lmac+grid2": dict(GRID2, traversal_mode="lmac", frontier_cap=4096),
    "gwalk+grid": dict(GWALK, farfield="grid", grid_level=3),
    "lists+m2p": dict(traversal_mode="lists", farfield="m2p"),
    "quad+comp": dict(farfield="m2p", multipole_order=2,
                      accum="compensated"),
    "2d": dict(ndim=2, farfield="m2p"),
}
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
jax_query = jax.jit(jengine.acc_pot_u,
                    static_argnames=("cfg", "with_stats", "mode"))
_STATE = {}


@pytest.fixture(autouse=True)
def _diag(monkeypatch):
    # the lists path is the reference's diagnostic mode
    monkeypatch.setenv("RAKAU_DIAG_MODES", "1")


def _particles(ndim):
    rng = np.random.default_rng(31 + ndim)
    u = rng.uniform(1e-6, 1 - 1e-6, N)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((N, ndim))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * r[:, None]).astype(np.float32), np.full(N, 1.0 / N,
                                                        np.float32)


def _imports():
    """E imported sources: half through the cloud's core, half on a far
    shell, as tests/test_torch_extra.py makes them."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((E, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    rad = np.concatenate([rng.uniform(0.05, 2.0, E // 2),
                          rng.uniform(15.0, 25.0, E - E // 2)])
    return ((w * rad[:, None]).astype(np.float32),
            (rng.uniform(0.5, 1.5, E) / N).astype(np.float32))


def _case(name):
    """(JAX config, JAX tree, port config, port tree), cached; gwalk's
    configuration is the reference's tune_gwalk fit."""
    if name not in _STATE:
        jc = JaxConfig(**{**BASE, **CASES[name]})
        pos, mass = _particles(jc.ndim)
        jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
        if jc.traversal_mode == "gwalk":
            jc = jengine.tune_gwalk(jtd, jc, THETA, EPS)
            assert jc.gwalk_round_caps is not None
        td = treedata_from_numpy(
            {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
        _STATE[name] = (jc, jtd, config_from_jax(jc), td)
    return _STATE[name]


def _rms(a, ref):
    a = np.asarray(a, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(a - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


def _assert_matches(got, want):
    a, p, o, m = got
    a_j, p_j, o_j, m_j = (np.asarray(x) for x in want)
    assert not o_j.any()
    np.testing.assert_array_equal(o.numpy(), o_j)
    np.testing.assert_array_equal(m.numpy(), m_j)
    assert _rms(a, a_j) <= 1e-5
    assert _rms(p, p_j) <= 1e-5


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("name", list(CASES))
def test_acc_pot_u_matches_jax(name):
    jc, jtd, cfg, td = _case(name)
    want = jax_query(jtd, jc, jnp.float32(THETA), jnp.float32(EPS), 1.0,
                     with_stats=True)
    got = engine.acc_pot_u(td, cfg, THETA, EPS, 1.0, with_stats=True)
    assert len(got) == 4 and got[0].shape == td.pos.shape
    _assert_matches(got, want)


@pytest.mark.parametrize("mode", ["acc", "pot"])
def test_acc_pot_u_modes_match_jax(mode):
    """mode "acc" / "pot", and the three-tuple without with_stats."""
    jc, jtd, cfg, td = _case("shared+grid")
    a_j, p_j, o_j = jax_query(jtd, jc, jnp.float32(THETA), jnp.float32(EPS),
                              1.0, mode=mode)
    got = engine.acc_pot_u(td, cfg, THETA, EPS, 1.0, mode=mode)
    assert len(got) == 3
    a, p, o = got
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    assert _rms(a, a_j) <= 1e-5 and _rms(p, p_j) <= 1e-5
    live = a if mode == "acc" else p
    assert float(live.abs().max()) > 0


def test_acc_pot_u_imports_match_jax():
    jc, jtd, cfg, td = _case("shared+local")
    e_pos, e_mass = _imports()
    want = jax_query(jtd, jc, jnp.float32(THETA), jnp.float32(EPS), 1.0,
                     with_stats=True, extra=(jnp.asarray(e_pos),
                                             jnp.asarray(e_mass)))
    extra = (torch.tensor(e_pos), torch.tensor(e_mass))
    got = engine.acc_pot_u(td, cfg, THETA, EPS, 1.0, with_stats=True,
                           extra=extra)
    _assert_matches(got, want)
    host = engine.acc_pot_u_host(td, cfg, THETA, EPS, 1.0, extra=extra)
    assert torch.equal(got[0], host[0]) and torch.equal(got[1], host[1])


def test_acc_pot_u_refuses_imports_where_the_host_query_does():
    e_pos, e_mass = _imports()
    extra = (torch.tensor(e_pos), torch.tensor(e_mass))
    _, _, cfg, td = _case("gwalk+grid")
    with pytest.raises(NotImplementedError):
        engine.acc_pot_u(td, cfg, THETA, EPS, extra=extra)
    _, _, cfg, td = _case("lists+m2p")
    with pytest.raises(ValueError, match="lists"):
        engine.acc_pot_u(td, cfg, THETA, EPS, extra=extra)


# -------------------------------------------- against the port's own query
@pytest.mark.parametrize("name", list(CASES))
def test_acc_pot_u_sums_equal_the_host_query(name):
    """Every chunk of the tile capacity and, for lmac, the un-sliced
    predicate give the sums of the sliced query over the live chunks, bit
    for bit."""
    _, _, cfg, td = _case(name)
    a, p, o = engine.acc_pot_u(td, cfg, THETA, EPS, 1.0)
    a_h, p_h, o_h, _ = engine.acc_pot_u_host(td, cfg, THETA, EPS, 1.0)
    assert torch.equal(a, a_h) and torch.equal(p, p_h)
    assert torch.equal(o, o_h)


# ------------------------------------------------------------- slicing
@pytest.mark.parametrize("name", ["shared+grid2", "lists+m2p",
                                  "lmac+grid2"])
def test_slicing_changes_no_sum(name, monkeypatch):
    """run_chunks at slice_chunks 1, 3 and all: the same sums bit for
    bit, with the last slice moved back and evaluated whole (every slice
    evaluates K chunks: evaluated_chunks). Flags and maxima are equal on
    shared and lists; on lmac the candidate table's slot (flag 3,
    maximum 2) is the OR and max over the slices' tables."""
    _, _, cfg, td = _case(name)
    cfg = cfg.with_(tile_chunk=4)   # 17 live chunks: a last slice moved back
    state = engine._query_state(td, cfg, EPS)
    n_live = engine.live_chunks(td, cfg)
    assert n_live > 3 and n_live % 3, n_live
    seen = []
    orig = engine._eval_chunk

    def count(*a, **kw):
        seen.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(engine, "_eval_chunk", count)
    runs = {}
    for k in (1, 3, n_live):
        seen.clear()
        runs[k] = engine.run_chunks(
            td, cfg, *engine.scalars(td.pos, THETA, EPS, 1.0), state, 0,
            n_live, slice_chunks=k)
        assert len(seen) == engine.evaluated_chunks(n_live, cfg.tile_chunk,
                                                    k)
    assert engine.evaluated_chunks(n_live, cfg.tile_chunk, 3) > n_live
    a, p, o, m = runs[n_live]
    assert a.shape[0] == n_live * cfg.tile_chunk
    for k in (1, 3):
        a_k, p_k, o_k, m_k = runs[k]
        assert torch.equal(a_k, a) and torch.equal(p_k, p), k
        if cfg.traversal_mode != "lmac":
            assert torch.equal(o_k, o) and torch.equal(m_k, m), k
            continue
        assert torch.equal(o_k[:3], o[:3]) and torch.equal(m_k[[0, 1, 3]],
                                                           m[[0, 1, 3]])
        cands = [engine._slice_cand(td, cfg, THETA, tuple(
            t[start:start + K] for t in state[0]), state[1])
            for _, start, K in engine._slices(n_live, cfg.tile_chunk, k)]
        assert int(m_k[2]) == max(int(c.count) for c in cands)
        assert bool(o_k[3]) == any(bool(c.overflow) for c in cands)


# ----------------------------------------------- what a capture rests on
BAD_OPS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
           "aten.unique", "aten._unique", "aten.is_nonzero", "aten.equal")


class _HostReads(TorchDispatchMode):
    """Records every op that reads a device value on the host (a sync a
    CUDA graph capture refuses), outside the plain kernel versions (the
    card runs the kernels instead)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name.startswith(BAD_OPS)
        if name.startswith(("aten.index.", "aten.index_put")) and \
                len(args) > 1 and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool
                    for i in (args[1] or ())):
            bad = True
        if bad:
            import traceback
            frames = [f for f in traceback.extract_stack()
                      if "rakau_tpu_torch" in f.filename]
            if not any(os.sep + "kernels" + os.sep in f.filename
                       for f in frames):
                self.hits.append((name, frames[-1].filename,
                                  frames[-1].lineno))
        return func(*args, **(kwargs or {}))


def forbid_host_copies(monkeypatch):
    """Make torch.as_tensor (of anything but a tensor), torch.tensor and
    torch.from_numpy raise: the ways host data is copied into a tensor."""
    as_tensor = torch.as_tensor

    def refuse(data, *a, **kw):
        raise AssertionError(f"host data copied into a tensor: {data!r}")

    def tensor_only(data, *a, **kw):
        if not isinstance(data, torch.Tensor):
            refuse(data)
        return as_tensor(data, *a, **kw)

    monkeypatch.setattr(torch, "as_tensor", tensor_only)
    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)


@pytest.mark.parametrize("name", ["shared+grid", "shared+grid2",
                                  "lmac+grid2", "gwalk+grid", "lists+m2p",
                                  "quad+comp"])
def test_query_reads_nothing_from_the_host(name, monkeypatch):
    """acc_pot_u issues no host read and, once its constant tables are
    made (a first run), no host-to-device copy of host data: what the
    capture of the whole query as one CUDA graph needs on the card."""
    _, _, cfg, td = _case(name)
    engine.acc_pot_u(td, cfg, THETA, EPS)
    forbid_host_copies(monkeypatch)
    reads = _HostReads()
    with reads:
        engine.acc_pot_u(td, cfg, THETA, EPS)
    assert not reads.hits, reads.hits[:5]


# --------------------------------------------------------------- graphs
def test_graph_true_on_cpu_tensors_raises():
    _, _, cfg, td = _case("shared+grid")
    state = engine._query_state(td, cfg, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        engine.acc_pot_u(td, cfg, THETA, EPS, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        engine.acc_pot_u_host(td, cfg, THETA, EPS, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        engine.run_chunks(td, cfg, *engine.scalars(td.pos, THETA, EPS, 1.0),
                          state, 0, 1, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphCache()(torch.neg, torch.ones(3))
    # graph=False and None run eagerly on CPU tensors, to the same sums
    a0 = engine.acc_pot_u(td, cfg, THETA, EPS, graph=False)[0]
    assert torch.equal(a0, engine.acc_pot_u(td, cfg, THETA, EPS)[0])


def _key(*args, **kw):
    return graphs.GraphCache().key(engine._slice_impl, args, kw)[0]


def test_graph_cache_key_tells_calls_apart():
    cfg = TreeConfig(ncrit=64, tile_chunk=8)
    x = torch.zeros(4, 3)
    base = _key(x, cfg, 0.75, 0.0, mode="both")
    assert _key(torch.ones(4, 3), cfg, 0.75, 0.0, mode="both") == base
    for other in (_key(x, cfg.with_(tile_chunk=4), 0.75, 0.0, mode="both"),
                  _key(torch.zeros(5, 3), cfg, 0.75, 0.0, mode="both"),
                  _key(x.double(), cfg, 0.75, 0.0, mode="both"),
                  _key(x, cfg, 0.75, 0.0, mode="acc"),
                  _key(x, cfg, 0.5, 0.0, mode="both"),
                  _key(x, cfg, 0.75, 0.01, mode="both"),
                  _key(x, cfg, 0.75, 0, mode="both"),
                  _key((x, None), cfg, 0.75, 0.0, mode="both"),
                  _key(x.int(), cfg, 0.75, 0.0, mode="both")):
        assert other != base
    assert (graphs.GraphCache().key(engine._slice_impl, (x,), {}, key=1)[0]
            != graphs.GraphCache().key(engine._slice_impl, (x,), {},
                                       key=2)[0])
    # the template rebuilds the arguments, tensors in their slots
    _, _, _, td = _case("shared+grid")
    tensors = []
    tpl = graphs._flatten(((td, cfg, [1.0, None], {"m": "acc"}), {}),
                          tensors)
    (td2, cfg2, lst, d), _ = graphs._build(tpl, tensors)
    assert type(td2) is type(td) and cfg2 == cfg
    assert lst == [1.0, None] and d == {"m": "acc"}
    assert all(a is b for a, b in zip(td2, td))


def test_graphs_imports_nothing_but_torch():
    code = ("import sys; import rakau_tpu_torch.graphs; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'triton', "
            "'rakau_tpu')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


# ----------------------------------------------- capture-safe constants
def test_constant_tables_equal_the_numpy_built_ones(monkeypatch):
    dev = torch.device("cpu")
    offs, bits = grid.stencil_offsets(3)
    o_t, b_t = grid._stencil_tensors(3, dev)
    assert np.array_equal(o_t.numpy(), offs)
    assert np.array_equal(b_t.numpy(), bits)
    assert grid._stencil_tensors(3, dev)[0] is o_t        # made once

    A, K, C = grid2._t_tensor_basis(3, 5)
    K_t, A_t, C_t = grid2._t_basis_tensors(3, 5, dev)
    assert np.array_equal(K_t.numpy(), K) and np.array_equal(A_t.numpy(), A)
    assert np.array_equal(C_t.numpy(), C)

    # the M2L kernels, W, rebuilt here from the NumPy tables
    ndim, p, q, sep = 3, 3, 2, 2
    s_cell, eps = torch.tensor(0.37), 0.05
    offs_np, bits_np = grid2.stencil_offsets(ndim, sep)
    pad = 2 * sep - 1
    Kw = 2 * pad + 1
    d = -torch.as_tensor(offs_np, dtype=torch.float64)
    T = grid2.t_tensors(d, torch.tensor(eps, dtype=torch.float64)
                        / s_cell.double(), ndim, p + q)
    gpos, coef = grid2._m2l_index_maps(ndim, p, q)
    Kmat = (T[:, torch.as_tensor(gpos.reshape(-1).astype(np.int64))]
            * torch.as_tensor(coef.reshape(-1))).T.float()
    flat = np.zeros(len(offs_np), np.int64)
    for dd in range(ndim):
        flat = flat * Kw + (offs_np[:, dd] + pad)
    want = torch.zeros((2 ** ndim, gpos.size, Kw ** ndim))
    for b in range(2 ** ndim):
        sel = np.nonzero((bits_np >> b) & 1)[0]
        want[b][:, torch.as_tensor(flat[sel])] = Kmat[:, torch.as_tensor(sel)]
    want = want.reshape((2 ** ndim,) + gpos.shape + (Kw,) * ndim)
    want = want.permute((0,) + tuple(range(3, 3 + ndim)) + (1, 2))
    got = grid2.m2l_kernels(ndim, p, q, sep, s_cell, eps, device=dev)
    assert torch.equal(got, want)

    shifts = grid2._parity_shifts(3, 4, "l2l", torch.float32, dev)
    for bidx, S in enumerate(shifts):
        t = [(((bidx >> dd) & 1) - 0.5) * 0.5 for dd in range(3)]
        assert torch.equal(S, grid2.shift_matrix(t, 3, 4, "l2l",
                                                 halving=True))

    betas, lookup, fact = grid2.multi_indices(3, 4)
    assert np.array_equal(grid2._exponents(betas, dev).numpy(),
                          np.asarray(betas))
    fact_t, low_t, ups = grid2._l2p_tables(3, 4, torch.float32, dev)
    assert torch.equal(fact_t, torch.as_tensor(fact, dtype=torch.float32))
    low = [i for i, b in enumerate(betas) if sum(b) <= 3]
    assert low_t.tolist() == low
    for dd, up in enumerate(ups):
        assert up.tolist() == [lookup[betas[i][:dd] + (betas[i][dd] + 1,)
                                      + betas[i][dd + 1:]] for i in low]

    # numbers are filled in on the device, to the same values
    cells = torch.randint(0, 1 << 10, (64, 3))
    box = torch.tensor(4.0)
    assert torch.equal(particles.cell_center(cells, box, 10, 6),
                       particles.cell_center(cells, box, 10,
                                             torch.tensor(6)))

    # a table first asked for inside a capture raises
    @graphs.device_constant
    def table(n, device):
        return torch.arange(n, device=device)

    monkeypatch.setattr(graphs, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        table(3, dev)
    monkeypatch.setattr(graphs, "capturing", lambda: False)
    assert table(3, dev).tolist() == [0, 1, 2]
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    assert table(3, dev).tolist() == [0, 1, 2]            # a hit is served


def test_pool_sentinel_number_equals_tensor():
    """traversal4.build_pool's sentinel given as a number (filled in on
    the device) lays out the same pool as given as a tensor."""
    jc, _, cfg, td = _case("gwalk+grid")
    tiles = engine._gather_tiles(td, cfg)
    flat, gl, _, _ = engine._gwalk_sources(td, cfg, THETA, tiles)
    G0 = flat[0].shape[0]
    kw = dict(window_blocks=cfg.pool_window // cfg.pool_block,
              group=cfg.pool_group)
    cap = -(-cfg.p2p_src_cap // cfg.pool_window) * cfg.pool_window
    s = 4.0 * float(td.box_size)
    a = traversal4.build_pool(td, gl, G0, cfg.pool_block, cap, sentinel=s,
                              **kw)
    b = traversal4.build_pool(td, gl, G0, cfg.pool_block, cap,
                              sentinel=torch.tensor(s), **kw)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.idx, b.idx)


@pytest.mark.parametrize("switch", ["shared", "tiles", "tf32"])
def test_capture_key_holds_each_switch(switch):
    """dispatch.capture_key, which every graph's key takes, changes with
    each global switch a captured query reads and comes back after it."""
    from rakau_tpu_torch.kernels import dispatch
    base = dispatch.capture_key()
    if switch == "shared":
        with dispatch.shared_variant("mma", "bf16"):
            assert dispatch.capture_key() != base
    elif switch == "tiles":
        with dispatch.tiles_variant("split"):
            assert dispatch.capture_key() != base
    else:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = not saved
        try:
            assert dispatch.capture_key() != base
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
    assert dispatch.capture_key() == base


def test_graph_cache_tally_and_clear():
    """The cache's tally starts at zero for each of its counters, and
    clear() (engine.clear_graphs on the CPU too) leaves it empty."""
    counts = {"a": 0}
    cache = graphs.GraphCache(counters=(counts,))
    assert cache.captured == [{}] and cache.replayed == [{}]
    graphs._add(cache.replayed, [{"a": 3}])
    graphs._add(cache.replayed, [{"a": 2}])
    assert cache.replayed == [{"a": 5}] and counts == {"a": 0}
    cache.reset_tally()
    assert cache.replayed == [{}]
    cache.clear()
    assert len(cache) == 0
    engine.clear_graphs()
    assert len(engine._GRAPHS) == 0
