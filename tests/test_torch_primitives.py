"""rakau_tpu_torch primitives against rakau_tpu: Morton codes, scans,
compaction, discretization, the config, and the import boundary (the
port must not pull in JAX). Integer results must be exactly equal."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import morton as jmorton
from rakau_tpu import particles as jparticles
from rakau_tpu import scan_utils as jsu
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.config import fit_caps as jax_fit_caps
from rakau_tpu.config import grow_overflowed as jax_grow_overflowed
from rakau_tpu_torch import morton, particles
from rakau_tpu_torch import scan_utils as su
from rakau_tpu_torch.config import TreeConfig, fit_caps, grow_overflowed
from rakau_tpu_torch.convert import config_from_jax

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("ndim,depth", [(3, 10), (3, 21), (2, 31)])
def test_morton_matches_jax(ndim, depth):
    rng = np.random.default_rng(depth)
    cells = rng.integers(0, 2 ** depth, (500, ndim)).astype(np.uint32)
    cells[0] = 0
    cells[1] = 2 ** depth - 1
    hi, lo = jmorton.encode(jnp.asarray(cells), ndim, depth)
    want = jmorton.to_uint64_np(hi, lo).astype(np.int64)
    code = morton.encode(torch.as_tensor(cells.astype(np.int64)), ndim, depth)
    np.testing.assert_array_equal(code.numpy(), want)
    np.testing.assert_array_equal(
        morton.decode(code, ndim, depth).numpy(), cells.astype(np.int64))


def test_clz64_exact():
    rng = np.random.default_rng(1)
    x = np.concatenate([[0, 1, 2, 3, (1 << 62), (1 << 63) - 1, 1 << 53,
                         (1 << 53) + 1],
                        rng.integers(0, 1 << 62, 300),
                        1 << rng.integers(0, 63, 100)]).astype(np.int64)
    want = [64 - int(v).bit_length() for v in x]
    np.testing.assert_array_equal(su.clz64(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("shape,cap", [((300,), 64), ((300,), 400),
                                       ((5, 97), 30), ((5, 97), 97)])
def test_compact_indices_matches_jax(shape, cap):
    mask = np.random.default_rng(cap).uniform(size=shape) < 0.3
    mask[..., -1] = True
    ji, jc = jsu.compact_indices(jnp.asarray(mask), cap)
    ti, tc = su.compact_indices(torch.as_tensor(mask), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_searchsorted_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(rng.integers(0, 1000, 257)).astype(np.int32)
    v = rng.integers(-5, 1005, (7, 33)).astype(np.int32)
    got = su.searchsorted_1d(torch.as_tensor(a).long(), torch.as_tensor(v))
    want = jsu.searchsorted_1d(jnp.asarray(a), jnp.asarray(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = np.sort(rng.integers(0, 100, (4, 50)), axis=1).astype(np.int32)
    q = rng.integers(-1, 101, (4, 20)).astype(np.int32)
    got = su.searchsorted_rows(torch.as_tensor(rows), torch.as_tensor(q))
    want = jsu.searchsorted_rows(jnp.asarray(rows), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_sums_match_numpy():
    rng = np.random.default_rng(3)
    v = rng.standard_normal((200, 3))
    b = rng.integers(0, 200, 40)
    e = np.minimum(b + rng.integers(0, 30, 40), 200)
    e[:3] = b[:3]                                   # empty ranges
    got = su.segment_sum_from_prefix(su.prefix_sums(torch.as_tensor(v)),
                                     torch.as_tensor(b), torch.as_tensor(e))
    want = np.stack([v[i:j].sum(0) for i, j in zip(b, e)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("depth", [10, 21])
def test_discretize_and_box_match_jax(depth):
    rng = np.random.default_rng(depth)
    pos = (rng.standard_normal((2000, 3)) * 3).astype(np.float32)
    box_j = jparticles.auto_box_size(jnp.asarray(pos))
    box_t = particles.auto_box_size(torch.as_tensor(pos))
    assert float(box_t) == float(box_j)
    # particles on and next to cell faces
    h = float(box_t) / 2 ** depth
    pos[:50] = (np.round(pos[:50] / h) * h).astype(np.float32)
    pos[50:100] = np.nextafter(pos[:50], np.float32(np.inf))
    want = jparticles.discretize(jnp.asarray(pos), box_j, depth)
    got = particles.discretize(torch.as_tensor(pos), box_t, depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lv = rng.integers(0, depth + 1, 2000)
    cj = jparticles.cell_center(want, box_j, depth, jnp.asarray(lv))
    ct = particles.cell_center(got, box_t, depth, torch.as_tensor(lv))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6 * float(box_t))


def test_validation_raises():
    pos = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="non-finite"):
        particles.raise_on_invalid(pos.clone().fill_(float("nan")),
                                   torch.ones(4), 1.0)
    with pytest.raises(ValueError, match="outside"):
        particles.raise_on_invalid(pos + 0.6, torch.ones(4), 1.0)
    with pytest.raises(ValueError, match="same length"):
        particles.raise_on_invalid(pos, torch.ones(3), 1.0)


@pytest.mark.parametrize("kw", [
    dict(), dict(farfield="grid", grid_level=3, mac="bh_geom"),
    dict(traversal_mode="gwalk", farfield="grid2", multipole_order=2),
    dict(ndim=2, dtype="float64", max_leaf_n=8, accum="compensated"),
])
def test_config_round_trip(kw):
    jc = JaxConfig(**kw)
    tc = config_from_jax(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.code_bits == jc.code_bits
    assert tc.node_capacity(5000) == jc.node_capacity(5000)
    flags, mx = [True, False, True, False], [3000, 20000, 700, 900]
    assert grow_overflowed(tc, flags) == config_from_jax(
        jax_grow_overflowed(jc, flags))
    assert fit_caps(tc, mx) == config_from_jax(jax_fit_caps(jc, mx))


@pytest.mark.parametrize("kw", [
    dict(traversal_mode="lists"), dict(multipole_order=2),
    dict(farfield="grid2", traversal_mode="lists"), dict(local_order=5),
    dict(mac="x"), dict(local_gamma=1.0), dict(max_depth=30),
])
def test_config_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        TreeConfig(**kw)


def test_import_pulls_in_no_jax():
    code = ("import rakau_tpu_torch, sys; "
            "import rakau_tpu_torch.parallel.mesh, "
            "rakau_tpu_torch.parallel.sharded, rakau_tpu_torch.parallel.let; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'triton', "
            "'rakau_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)
