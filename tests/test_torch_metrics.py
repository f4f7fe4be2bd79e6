"""rakau_tpu_torch.metrics against rakau_tpu.metrics on one JAX-built
tree handed over through rakau_tpu_torch.convert: the useful, processed
and slot pair counts of the shared and the lmac query (to 1e-6: the
reference sums them in float32), with the reference's kernel block set to
the port's (RAKAU_PALLAS_BLOCK) and row caps of at least one block (below
it the reference shrinks its block to the row, the port does not). The
processed pairs must be the count that the kernel wrapper's own
active-block plan gives for the engine's masks on the same chunks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import metrics as jmetrics
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import engine, metrics
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.kernels import shared

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

N = 4096
THETA = 0.7
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
BASE = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=16,
            m2p_cap=2048, p2p_leaf_cap=1024, p2p_src_cap=4096,
            frontier_cap=4096)
CASES = {
    "shared-grid": dict(farfield="grid", grid_level=3),
    "lmac-grid2": dict(traversal_mode="lmac", farfield="grid2",
                       grid_level=3, grid_sep=2, local_order=3),
    "lmac-m2p-quad": dict(traversal_mode="lmac", farfield="m2p",
                          multipole_order=2),
}


def particles_np(n, seed=51):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_shared_density_matches_jax_and_the_kernels_plan(case, monkeypatch):
    jc = JaxConfig(**{**BASE, **CASES[case]})
    cfg = config_from_jax(jc)
    pos, mass = particles_np(N)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    monkeypatch.setenv("RAKAU_PALLAS_BLOCK", str(shared.BLOCK))
    want = jmetrics.collect_shared_density(jtd, jc, THETA, max_chunks=3)
    got = metrics.collect_shared_density(td, cfg, THETA, max_chunks=3)
    for f in ("useful_pairs", "processed_pairs", "slot_pairs", "density",
              "slot_density", "pairs_per_particle"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, err_msg=f)
    assert got.chunks_sampled == want.chunks_sampled == 3
    assert got.block == want.block == shared.BLOCK and got.subblock == 0
    assert 0 < got.density <= 1 and got.useful_pairs > 0

    # the replay is the kernel's own plan: what the wrapper's active-block
    # lists give for the masks the engine hands it, on the same chunks
    n_live = engine.live_chunks(td, cfg)
    sample = metrics.sample_chunks(n_live, 3)
    blocks = 0
    for ch in sample:
        inp = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)
        mask, quad = inp[5], inp[6]
        if quad is None:
            blocks += int(shared.active_blocks(mask)[1].sum())
        else:       # two launches: node rows, particle rows
            U = quad.shape[0]
            blocks += int(shared.active_blocks(
                mask[:, :U].contiguous())[1].sum())
            blocks += int(shared.active_blocks(
                mask[:, U:].contiguous())[1].sum())
    assert got.processed_pairs == pytest.approx(
        blocks * shared.BLOCK * cfg.ncrit * n_live / len(sample), rel=1e-12)


def test_density_needs_a_shared_row():
    cfg = config_from_jax(JaxConfig(**{**BASE, "traversal_mode": "gwalk",
                                       "farfield": "m2p"}))
    pos, mass = particles_np(256)
    from rakau_tpu_torch import build
    td = build.build_tree(torch.as_tensor(pos), torch.as_tensor(mass), cfg)
    with pytest.raises(ValueError, match="shared"):
        metrics.collect_shared_density(td, cfg, THETA)


def test_sample_chunks_takes_bin_midpoints():
    assert metrics.sample_chunks(100, 4) == [12, 37, 62, 87]
    assert metrics.sample_chunks(3, 8) == [0, 1, 2]
    assert metrics.sample_chunks(1, 8) == [0]


def test_fitted_caps_match_jax():
    kw = dict(n=1000, n_nodes=300, n_tiles=20, tile_fill=0.8, m2p_mean=100.0,
              m2p_p95=200.0, m2p_max=777, m2p_cap=4096, p2p_mean=500.0,
              p2p_p95=900.0, p2p_max=3001, p2p_src_cap=8192, m2p_waste=0.9,
              p2p_waste=0.9, interactions_m2p=1e6, interactions_p2p=2e6)
    for slack, quantum in ((1.25, 512), (1.0, 256), (2.0, 1000)):
        want = jmetrics.fitted_caps(jmetrics.QueryStats(**kw), slack,
                                    quantum)
        got = metrics.fitted_caps(metrics.QueryStats(**kw), slack, quantum)
        assert got == want
    assert metrics.QueryStats(**kw).as_dict() == kw


def test_query_stats_and_roof_raise_where_they_cannot_run():
    """The roof times the CUDA kernels and refuses a CPU device
    (collect_query_stats runs anywhere: tests/test_torch_lists.py)."""
    cfg = config_from_jax(JaxConfig(**BASE))
    with pytest.raises(ValueError, match="CUDA"):
        metrics.measure_kernel_roof(cfg, n_src=1024, device="cpu")
