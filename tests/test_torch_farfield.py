"""rakau_tpu_torch.expansion and .grid against rakau_tpu: the Taylor
M2L/L2P/L2L/far-split operators and the dense stencil far field, in
float64 at rtol 1e-10 (the algorithm: only the summation order differs)
and in float32 at rtol 1e-5 (the working precision).

The reference's pyramid binning sums through float32 double-double
prefixes whatever the input dtype, so in float64 the pyramid is held
against a float64 NumPy binning instead, and the dense far field is fed
the same pyramid on both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import expansion as jexp
from rakau_tpu import grid as jgrid
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import build, expansion, grid
from rakau_tpu_torch.convert import config_from_jax

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

TOL = {np.float64: dict(rtol=1e-10, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=1e-6)}
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
jax_pyramid = jax.jit(jgrid.build_pyramid, static_argnums=(1, 2, 3))
jax_dense = jax.jit(jgrid.dense_far_field, static_argnums=(1, 2, 5))


def _close(got, want, dt, scale=1.0):
    tol = TOL[dt]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=tol["rtol"], atol=tol["atol"] * scale)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("order", [2, 3])
def test_expansion_operators_match_jax(dt, order):
    rng = np.random.default_rng(order)
    C, U, T = 5, 40, 16
    center = rng.standard_normal((C, 3)).astype(dt)
    npos = (rng.standard_normal((U, 3)) * 4).astype(dt)
    nmass = rng.uniform(0.1, 1, U).astype(dt)
    nmass[:3] = 0
    mask = rng.uniform(size=(C, U)) < 0.6
    rad2 = rng.uniform(0.01, 1.5, C).astype(dt)
    tpos = (center[:, None, :] + 0.3 * rng.standard_normal((C, T, 3))
            ).astype(dt)
    shift = (0.2 * rng.standard_normal((C, 3))).astype(dt)
    t = torch.as_tensor
    j = jnp.asarray
    eps = 0.01

    far_t, near_t = expansion.far_split(t(center), t(rad2), t(npos),
                                        t(nmass), t(mask), 2.0)
    far_j, near_j = jexp.far_split(j(center), j(rad2), j(npos), j(nmass),
                                   j(mask), 2.0)
    np.testing.assert_array_equal(far_t.numpy(), np.asarray(far_j))
    np.testing.assert_array_equal(near_t.numpy(), np.asarray(near_j))
    assert far_t.any() and near_t.any()

    Lt = expansion.m2l(t(center), t(npos), t(nmass), far_t, eps, order)
    Lj = jexp.m2l(j(center), j(npos), j(nmass), far_j, jnp.asarray(eps, dt),
                  order)
    assert Lt.shape[1] == expansion.n_coeffs(3, order) == \
        jexp.n_coeffs(3, order)
    _close(Lt, Lj, dt, float(np.abs(np.asarray(Lj)).max()))

    at, pt = expansion.l2p(Lt, t(center), t(tpos), 1.5, order)
    aj, pj = jexp.l2p(Lj, j(center), j(tpos), 1.5, order)
    _close(at, aj, dt, float(np.abs(np.asarray(aj)).max()))
    _close(pt, pj, dt, float(np.abs(np.asarray(pj)).max()))

    L2t = expansion.l2l(Lt, t(shift), order)
    L2j = jexp.l2l(Lj, j(shift), order)
    _close(L2t, L2j, dt, float(np.abs(np.asarray(L2j)).max()))


def test_stencil_and_grid_level_match_jax():
    for ndim in (2, 3):
        o_t, b_t = grid.stencil_offsets(ndim)
        o_j, b_j = jgrid.stencil_offsets(ndim)
        np.testing.assert_array_equal(o_t, o_j)
        np.testing.assert_array_equal(b_t, b_j)
    for kw, n in ((dict(), 10 ** 6), (dict(ncrit=64), 2048),
                  (dict(ncrit=512, max_depth=14), 1 << 20),
                  (dict(grid_level=4), 100), (dict(ndim=2), 10 ** 5),
                  (dict(), 100)):
        jc = JaxConfig(**kw)
        assert grid.effective_grid_level(config_from_jax(jc), n) == \
            jgrid.effective_grid_level(jc, n)
    cells = torch.as_tensor(np.random.default_rng(0).integers(0, 8, (50, 3)))
    np.testing.assert_array_equal(
        grid.rowmajor_cell_index(cells, 3, 3).numpy(),
        np.asarray(jgrid.rowmajor_cell_index(jnp.asarray(cells), 3, 3)))


def _tree_pair(dt):
    rng = np.random.default_rng(31)
    n = 2048
    pos = np.concatenate([rng.standard_normal((n // 2, 3)) * 0.3,
                          rng.uniform(-2, 2, (n // 2, 3))]).astype(dt)
    mass = rng.uniform(0.5, 1.5, n).astype(dt) / n
    jc = JaxConfig(dtype=np.dtype(dt).name, max_depth=10, max_leaf_n=16,
                   ncrit=64, farfield="grid", grid_level=4)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass),
                          config_from_jax(jc))
    return jtd, td


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_pyramid_and_dense_far_field_match(dt):
    L0 = 4
    jtd, td = _tree_pair(dt)
    pyr_t = grid.build_pyramid(td, 3, 10, L0)
    pyr_j = jax_pyramid(jtd, 3, 10, L0)
    if dt == np.float32:
        for lvl in range(L0 + 1):
            m_j = np.asarray(pyr_j.mass[lvl])
            _close(pyr_t.mass[lvl], m_j, dt, float(m_j.max()))
            w_j = np.asarray(pyr_j.wsum[lvl])
            _close(pyr_t.wsum[lvl], w_j, dt, float(np.abs(w_j).max()))
    else:
        # float64 NumPy binning of the same particles
        pos = td.pos.numpy()
        mass = td.mass.numpy()
        box = float(td.box_size)
        cells = np.clip(np.floor((pos + box / 2) / box * 16), 0, 15)
        flat = (cells[:, 0] * 16 + cells[:, 1]) * 16 + cells[:, 2]
        m_np = np.bincount(flat.astype(np.int64), mass, 16 ** 3)
        _close(pyr_t.mass[L0], m_np, dt)
        for d in range(3):
            w_np = np.bincount(flat.astype(np.int64), mass * pos[:, d],
                               16 ** 3)
            _close(pyr_t.wsum[L0][:, d], w_np, dt)
    # the same pyramid on both sides
    pyr_np = jgrid.Pyramid(
        mass=tuple(jnp.asarray(m.numpy()) for m in pyr_t.mass),
        wsum=tuple(jnp.asarray(w.numpy()) for w in pyr_t.wsum))
    box = td.box_size
    Lt = grid.dense_far_field(pyr_t, 3, L0, box, 0.01, 3)
    Lj = jax_dense(pyr_np, 3, L0, jnp.asarray(box.numpy()),
                   jnp.asarray(0.01, dt), 3)
    Lj = np.asarray(Lj)
    assert Lt.shape == Lj.shape and np.abs(Lj).max() > 0
    # compare per coefficient column: their magnitudes differ by orders
    for k in range(Lj.shape[1]):
        _close(Lt[:, k], Lj[:, k], dt, float(np.abs(Lj[:, k]).max()))
