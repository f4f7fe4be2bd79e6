"""rakau_tpu_torch.grid2 (the conv-M2L far field) against rakau_tpu.grid2
on the same inputs, made from a seed with numpy.

Index tables exactly equal. The evaluated tables within rtol 1e-5 in
float32 (the port evaluates them in float64 and rounds once, the
reference sums the cancelling terms of a high-order T in float32, so
entries far below a table's maximum get an absolute tolerance of 1e-5 of
that maximum) and 1e-10 in float64. Pyramids, parity convolutions, leaf
locals and the particles' far field within 1e-5 of each quantity's
maximum (the reference's two convolution forms differ by 4e-7 of it).
The reference runs jitted, at orders 2-4 and grid_sep 2, each result
computed once; the high orders are held with the port alone against
the float64 direct sum, as tests/test_grid2.py holds the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import grid2 as jgrid2
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import build, grid2
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
_STATE = {}


def _close(got, want, rel=1e-5):
    """|got - want| <= rel * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max() / scale)


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("ndim,order", [(2, 5), (3, 4), (3, 8)])
def test_multi_indices_equal(ndim, order):
    a, la, fa = jgrid2.multi_indices(ndim, order)
    b, lb, fb = grid2.multi_indices(ndim, order)
    assert a == b and la == lb
    np.testing.assert_array_equal(fa, fb)
    assert grid2.n_coeffs(ndim, order) == jgrid2.n_coeffs(ndim, order) == len(b)


@pytest.mark.parametrize("ndim,sep", [(2, 2), (2, 3), (3, 2), (3, 3), (3, 4)])
def test_stencil_offsets_equal(ndim, sep):
    for a, b in zip(jgrid2.stencil_offsets(ndim, sep),
                    grid2.stencil_offsets(ndim, sep)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ndim,p,q", [(2, 4, 3), (3, 3, 3), (3, 6, 4)])
def test_index_maps_equal(ndim, p, q):
    for a, b in zip(jgrid2._m2l_index_maps(ndim, p, q),
                    grid2._m2l_index_maps(ndim, p, q)):
        np.testing.assert_array_equal(a, b)
    for kind in ("m2m", "l2l"):
        assert jgrid2._shift_maps(ndim, p, kind) \
            == grid2._shift_maps(ndim, p, kind)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_t_tensors_match_jax(dtype, rtol):
    rng = np.random.default_rng(0)
    d = (rng.normal(size=(40, 3)) * 3).astype(dtype)
    want = np.asarray(jgrid2.t_tensors(jnp.asarray(d), dtype(0.1), 3, 6))
    got = grid2.t_tensors(torch.as_tensor(d), 0.1, 3, 6).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("ndim,p,q,sep,dtype,rtol", [
    (3, 3, 2, 2, np.float32, 1e-5), (2, 4, 4, 3, np.float32, 1e-5),
    (3, 2, 2, 3, np.float64, 1e-10)])
def test_m2l_kernels_match_jax(ndim, p, q, sep, dtype, rtol):
    want = np.asarray(jgrid2.m2l_kernels(
        ndim, p, q, sep, dtype(0.25), dtype(0.05), jnp.dtype(dtype)))
    got = grid2.m2l_kernels(ndim, p, q, sep, 0.25, 0.05,
                            getattr(torch, np.dtype(dtype).name)).numpy()
    assert got.shape == want.shape and got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    # the stencil's zeros are exact zeros on both sides
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("kind", ["m2m", "l2l"])
@pytest.mark.parametrize("halving", [False, True])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_shift_matrix_matches_jax(kind, halving, dtype, rtol):
    t = np.asarray([0.13, -0.25, 0.08], dtype)
    want = np.asarray(jgrid2.shift_matrix(jnp.asarray(t), 3, 4, kind,
                                          halving))
    got = grid2.shift_matrix(torch.as_tensor(t), 3, 4, kind, halving).numpy()
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("n,occ,ncrit,mode,level,ndim", [
    (n, occ, ncrit, mode, level, ndim)
    for n in (20, 1000, 65536, 1 << 20, 1 << 23)
    for occ, ncrit in ((32, 512), (8, 64))
    for mode in ("shared", "gwalk")
    for level, ndim in ((None, 3), (None, 2), (2, 3))])
def test_effective_grid_level_equal(n, occ, ncrit, mode, level, ndim):
    kw = dict(ndim=ndim, farfield="grid2", traversal_mode=mode, ncrit=ncrit,
              grid_occupancy=occ, grid_level=level, max_depth=9)
    assert grid2.effective_grid_level(TreeConfig(**kw), n) \
        == jgrid2.effective_grid_level(JaxConfig(**kw), n)


# ------------------------------------------------- pyramid, conv, far field
def _sample(n, ndim=3, clustered=False, seed=5, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if clustered:
        pos = np.concatenate([
            rng.normal(size=(n // 2, ndim)) * 0.05 + 0.3,
            rng.normal(size=(n - n // 2, ndim)) * 0.2 - 0.2])
        pos = np.clip(pos, -0.99, 0.99)
    else:
        pos = rng.uniform(-0.5, 0.5, size=(n, ndim))
    return pos.astype(dtype), rng.uniform(0.5, 1.5, size=n).astype(dtype)


CASES = {
    "3d-o3": dict(ndim=3, local_order=3, grid_level=3, eps=0.01),
    "3d-o4q2": dict(ndim=3, local_order=4, grid_multipole_order=2,
                    grid_level=2, eps=0.0),
    "2d-o4": dict(ndim=2, local_order=4, grid_level=4, eps=0.0),
}


def _case(name):
    """One tree built by the reference, the port's copy of it, and the
    reference's pyramid, leaf locals and far field on it (jitted, cached)."""
    if name not in _STATE:
        kw = dict(CASES[name])
        eps = np.float32(kw.pop("eps"))
        ndim = kw["ndim"]
        pos, mass = _sample(1024, ndim, clustered=True)
        jc = JaxConfig(max_depth=10, max_leaf_n=16, ncrit=64,
                       farfield="grid2", grid_sep=2, **kw)
        jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
        L0 = jc.grid_level
        p = jc.local_order
        q = p if jc.grid_multipole_order is None else jc.grid_multipole_order

        @jax.jit
        def ref(td):
            pyr = jgrid2.build_pyramid(td, jc, L0, q)
            Lleaf = jgrid2.dense_far_field(pyr, jc, L0, td.box_size, eps, p,
                                           q, jc.grid_sep)
            cells = jgrid2.particle_cells(td.pos, td.box_size, jc.max_depth,
                                          L0)
            acc, pot = jgrid2.l2p_particles(Lleaf, cells, td.pos,
                                            td.box_size, L0,
                                            jnp.float32(1.5), p)
            return pyr.mom, Lleaf, cells, acc, pot

        mom, Lleaf, cells, acc, pot = ref(jtd)
        td = treedata_from_numpy(
            {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
        _STATE[name] = dict(
            cfg=config_from_jax(jc), td=td, eps=float(eps), L0=L0, p=p, q=q,
            mom=[np.array(m) for m in mom], Lleaf=np.array(Lleaf),
            cells=np.asarray(cells), acc=np.asarray(acc),
            pot=np.asarray(pot))
    return _STATE[name]


@pytest.mark.parametrize("name", list(CASES))
def test_build_pyramid_matches_jax(name):
    c = _case(name)
    pyr = grid2.build_pyramid(c["td"], c["cfg"], c["L0"], c["q"])
    assert len(pyr.mom) == c["L0"] + 1
    for got, want in zip(pyr.mom, c["mom"]):
        _close(got.numpy(), want)
    # the root monopole is the total mass
    np.testing.assert_allclose(float(pyr.mom[0][0, 0]),
                               float(c["td"].mass.double().sum()), rtol=1e-6)


def test_build_pyramid_float64_against_numpy_sums():
    """A float64 tree's leaf moments against float64 NumPy sums per cell
    (the reference's own float64 pyramid carries float32 prefix sums)."""
    pos, mass = _sample(600, clustered=True, dtype=np.float64)
    cfg = TreeConfig(dtype="float64", max_depth=10, max_leaf_n=8, ncrit=32,
                     farfield="grid2", local_order=3, grid_level=2)
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    pyr = grid2.build_pyramid(td, cfg, 2, 3)
    cells = grid2.particle_cells(td.pos, td.box_size, cfg.max_depth, 2).numpy()
    s0 = float(td.box_size) / 4
    delta = (td.pos.numpy() - ((cells + 0.5) * s0 - float(td.box_size) / 2)) / s0
    alphas, _, _ = grid2.multi_indices(3, 3)
    want = np.zeros((64, len(alphas)))
    flat = (cells[:, 0] * 4 + cells[:, 1]) * 4 + cells[:, 2]
    for i, a in enumerate(alphas):
        np.add.at(want[:, i], flat,
                  td.mass.numpy() * np.prod(delta ** np.asarray(a), axis=1))
    np.testing.assert_allclose(pyr.mom[2].numpy(), want, rtol=1e-11,
                               atol=1e-13)


@pytest.mark.parametrize("ndim", [2, 3])
def test_parity_conv_matches_jax_and_bruteforce(ndim):
    """_parity_conv against the reference's and against an explicit loop
    over the stencil offsets with their parity masks."""
    rng = np.random.default_rng(2)
    p = q = 2
    sep, L0 = 3, 3
    G = 1 << L0
    NM, NL = grid2.n_coeffs(ndim, q), grid2.n_coeffs(ndim, p)
    M = rng.normal(size=(G ** ndim, NM))
    W = grid2.m2l_kernels(ndim, p, q, sep, 0.125, 0.0, torch.float64)
    out = grid2._parity_conv(torch.as_tensor(M), W, ndim, G).numpy()
    want_j = np.asarray(jgrid2._parity_conv(
        jnp.asarray(M), jnp.asarray(W.numpy()), ndim, G))
    np.testing.assert_allclose(out, want_j, rtol=1e-9, atol=1e-11)

    offs, bits = grid2.stencil_offsets(ndim, sep)
    Mg = M.reshape((G,) * ndim + (NM,))
    want = np.zeros((G,) * ndim + (NL,))
    Tall = grid2.t_tensors(torch.as_tensor(-offs, dtype=torch.float64), 0.0,
                           ndim, p + q).numpy()
    gpos, coef = grid2._m2l_index_maps(ndim, p, q)
    Kmat = Tall[:, gpos.reshape(-1)].reshape(offs.shape[0], NL, NM) * coef
    for t in np.ndindex(*(G,) * ndim):
        bidx = sum((t[d] & 1) << d for d in range(ndim))
        for oi in range(offs.shape[0]):
            s = tuple(t[d] + offs[oi, d] for d in range(ndim))
            if (bits[oi] >> bidx) & 1 and all(0 <= c < G for c in s):
                want[t] += Kmat[oi] @ Mg[s]
    np.testing.assert_allclose(out.reshape(want.shape), want, rtol=1e-8,
                               atol=1e-10)


def test_parity_conv_float32_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.normal(size=(8 ** 3, 20)).astype(np.float32)
    Wj = jgrid2.m2l_kernels(3, 3, 3, 2, jnp.float32(0.25), jnp.float32(0.0))
    want = np.asarray(jgrid2._parity_conv(jnp.asarray(M), Wj, 3, 8))
    got = grid2._parity_conv(torch.as_tensor(M),
                             torch.as_tensor(np.array(Wj)), 3, 8)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_dense_far_field_matches_jax(name):
    """The leaf locals from the REFERENCE's pyramid (handed over as NumPy
    arrays), so that the M2L and L2L chain is compared apart from the
    binning."""
    c = _case(name)
    pyr = grid2.Pyramid2(mom=tuple(torch.as_tensor(m) for m in c["mom"]))
    got = grid2.dense_far_field(pyr, c["cfg"], c["L0"], c["td"].box_size,
                                c["eps"], c["p"], c["q"], c["cfg"].grid_sep)
    _close(got.numpy(), c["Lleaf"])


@pytest.mark.parametrize("name", list(CASES))
def test_l2p_particles_matches_jax(name):
    """L2P from the REFERENCE's leaf locals; the cells exactly equal."""
    c = _case(name)
    td, cfg = c["td"], c["cfg"]
    cells = grid2.particle_cells(td.pos, td.box_size, cfg.max_depth, c["L0"])
    np.testing.assert_array_equal(cells.numpy(), c["cells"])
    acc, pot = grid2.l2p_particles(torch.as_tensor(c["Lleaf"]), cells,
                                   td.pos, td.box_size, c["L0"], 1.5, c["p"])
    _close(acc.numpy(), c["acc"])
    _close(pot.numpy(), c["pot"])


@pytest.mark.parametrize("name", list(CASES))
def test_far_field_matches_jax(name):
    c = _case(name)
    acc, pot = grid2.far_field(c["td"], c["cfg"], c["eps"], 1.5)
    _close(acc.numpy(), c["acc"])
    _close(pot.numpy(), c["pot"])
    # the kept leaf locals give the same field
    kept = grid2.leaf_locals(c["td"], c["cfg"], c["eps"])
    acc2, pot2 = grid2.far_field(c["td"], c["cfg"], c["eps"], 1.5,
                                 locals_=kept)
    assert torch.equal(acc, acc2) and torch.equal(pot, pot2)


def test_far_field_without_a_grid_is_zero():
    pos, mass = _sample(20)
    cfg = TreeConfig(farfield="grid2", max_depth=8)
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    assert grid2.effective_grid_level(cfg, 20) == 0
    assert grid2.leaf_locals(td, cfg, 0.0) is None
    acc, pot = grid2.far_field(td, cfg, 0.0, 1.0)
    assert not acc.any() and not pot.any()


# ------------------------------ the port alone against the float64 oracle
def _near_bruteforce(pos, mass, cells, sep, eps):
    """float64 direct sum over the pairs with cell separation < sep."""
    pos = np.asarray(pos, np.float64)
    mass = np.asarray(mass, np.float64)
    n = pos.shape[0]
    csep = np.abs(cells[:, None, :] - cells[None, :, :]).max(-1)
    near = (csep < sep) & ~np.eye(n, dtype=bool)
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1) + eps ** 2
    np.fill_diagonal(r2, 1.0)
    w = np.where(near, mass[None, :] / np.sqrt(r2), 0.0)
    return ((w / r2)[:, :, None] * d).sum(1), -w.sum(1)


def _far_plus_near(pos, mass, eps, order, ndim=3, sep=3):
    cfg = TreeConfig(ndim=ndim, farfield="grid2", local_order=order,
                     grid_multipole_order=order, grid_level=3, grid_sep=sep,
                     max_leaf_n=8, ncrit=32)
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    acc_f, pot_f = grid2.far_field(td, cfg, eps, 1.0)
    cells = grid2.particle_cells(td.pos, td.box_size, cfg.max_depth, 3)
    acc_n, pot_n = _near_bruteforce(td.pos.numpy(), td.mass.numpy(),
                                    cells.numpy(), sep, eps)
    acc_o, pot_o = direct_acc_pot_np(td.pos.numpy().astype(np.float64),
                                     td.mass.numpy().astype(np.float64),
                                     eps=eps)
    rel = np.linalg.norm(acc_f.numpy() + acc_n - acc_o, axis=1) \
        / np.linalg.norm(acc_o, axis=1)
    prel = np.abs(pot_f.numpy() + pot_n - pot_o) / np.abs(pot_o)
    return float(np.sqrt(np.mean(rel ** 2))), float(np.sqrt(np.mean(prel ** 2)))


@pytest.mark.parametrize("clustered", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_far_field_bookkeeping_exact(clustered, eps):
    """far_field + brute-force near field = direct sum, to the expansion
    error at order 6 (tests/test_grid2.py:164-194): the coverage test."""
    pos, mass = _sample(400, clustered=clustered, seed=9)
    a_rms, p_rms = _far_plus_near(pos, mass, eps, 6)
    assert a_rms < 5e-5, a_rms
    assert p_rms < 5e-5, p_rms


def test_far_field_bookkeeping_exact_2d():
    pos, mass = _sample(300, ndim=2, seed=9)
    a_rms, _ = _far_plus_near(pos, mass, 0.0, 6, ndim=2)
    assert a_rms < 5e-5, a_rms


def test_far_field_order_ladder():
    """A higher order gives a smaller far-field error: 2 > 4 > 6."""
    pos, mass = _sample(400, seed=9)
    errs = [_far_plus_near(pos, mass, 0.0, order)[0] for order in (2, 4, 6)]
    assert errs[2] < errs[1] < errs[0] < 5e-2, errs


def test_far_field_order_8_sep_4_is_finite_and_tighter():
    pos, mass = _sample(300, seed=9)
    e6, _ = _far_plus_near(pos, mass, 0.0, 6, sep=3)
    cfg_err, _ = _far_plus_near(pos, mass, 0.0, 8, sep=4)
    assert np.isfinite(cfg_err) and cfg_err < e6, (cfg_err, e6)


def test_full_precision_restores_the_switches():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32, torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with grid2._full_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cudnn.enabled
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.enabled == before[2]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before[:2]
