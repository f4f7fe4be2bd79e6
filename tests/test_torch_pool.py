"""The gwalk pool evaluation of rakau_tpu_torch on CPU tensors (the plain
PyTorch version of K2, directly and through dispatch) against
rakau_tpu's Pallas pool kernel in interpret mode, on the synthetic
schedule of tests/test_gwalk.py (tiles across two windows, an empty
tile, self pairs, second moments on the node blocks only), in the
monopole, compensated and quadrupole forms and every mode. Tolerance
rtol 2e-4, atol 2e-5: the bound tests/test_pallas.py holds the Pallas
kernels to. The reference's XLA version ignores `compensated` on the
monopole path, so the compensated forms are held against the Pallas
kernel.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it
against the plain version there. Here: its wrapper's input checks and
its build without a CUDA toolkit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu.kernels import pallas as pk
from rakau_tpu.kernels import xla as xk
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, pool, shared

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5
GT, T, BLOCK, WINDOW = 5, 16, 32, 128
# (window, start block, node blocks, particle blocks) per tile
SCHED = [[0, 0, 1, 1],     # blocks 0..2
         [0, 2, 0, 1],     # block 2
         [0, 3, 1, 0],     # block 3
         [1, 0, 2, 1],     # window 1, blocks 0..3
         [1, 3, 0, 0]]     # empty


def make_case(seed=42):
    """The synthetic pool of tests/test_gwalk.py: self pairs at rows 5 and
    40, second moments on the node blocks only; plus a node row exactly
    on a target (row 1, tile 0), where r2 = 0 at eps = 0."""
    rng = np.random.default_rng(seed)
    P = 2 * WINDOW
    n = 1000
    tpos = rng.standard_normal((GT, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(GT, T), replace=False).astype(np.int32)
    ppos = (rng.standard_normal((P, 3)) * 2).astype(np.float32)
    pmass = rng.uniform(0.1, 1, P).astype(np.float32)
    pidx = np.full(P, -1, np.int32)
    pidx[5] = tidx[0, 3]
    pidx[40] = tidx[2, 1]
    ppos[5] = tpos[0, 3]
    ppos[1] = tpos[0, 5]
    q = rng.standard_normal((P, 6)) * 0.05
    node_rows = np.zeros(P, bool)
    for w, s, mn, _ in SCHED:
        node_rows[w * WINDOW + s * BLOCK:w * WINDOW + (s + mn) * BLOCK] = True
    q[~node_rows] = 0.0
    quad = (q * pmass[:, None]).astype(np.float32)
    return tpos, tidx, ppos, pmass, pidx, np.asarray(SCHED, np.int32), quad


def _torch(case):
    return tuple(torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i"
                                 else a) for a in case)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("quad", [False, True])
def test_plain_matches_pallas(quad, comp, mode):
    case = make_case()
    t = _torch(case)
    j = tuple(jnp.asarray(a) for a in case)
    tq = t[6] if quad else None
    jq = j[6] if quad else None
    for eps in (0.01, 0.0):
        got = pool.eval_pool_plain(*t[:6], WINDOW, eps, 1.5, BLOCK,
                                   compensated=comp, mode=mode, pool_quad=tq)
        assert all(bool(torch.isfinite(x).all()) for x in got)
        want = pk.eval_pool(*j[:6], WINDOW, eps, 1.5, BLOCK,
                            compensated=comp, mode=mode, pool_quad=jq,
                            interpret=True)
        _close(got, want)
        if not comp:
            _close(got, xk.eval_pool(*j[:6], WINDOW, eps, 1.5, BLOCK,
                                     mode=mode, pool_quad=jq))
        # the empty tile gives exact zeros; the other output too
        assert not got[0][4].any() and not got[1][4].any()
        if mode == "acc":
            assert not got[1].any()
        elif mode == "pot":
            assert not got[0].any()
    if quad:
        # the quadrupole correction changes the answer
        mono = pool.eval_pool_plain(*t[:6], WINDOW, 0.01, 1.5, BLOCK,
                                    compensated=comp, mode=mode)
        k = 1 if mode == "pot" else 0
        assert (got[k] - mono[k]).abs().max() > 1e-6


@pytest.mark.parametrize("accum", ["fp32", "compensated"])
@pytest.mark.parametrize("quad", [False, True])
def test_dispatch_sends_cpu_tensors_to_the_plain_version(quad, accum):
    t = _torch(make_case(3))
    tq = t[6] if quad else None
    got = dispatch.eval_pool(TreeConfig(accum=accum), *t[:6], WINDOW, BLOCK,
                             0.01, 2.0, pool_quad=tq)
    want = pool.eval_pool_plain(*t[:6], WINDOW, 0.01, 2.0, BLOCK,
                                compensated=accum == "compensated",
                                pool_quad=tq)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_compensated_sum_is_closer_to_float64():
    """One tile whose segment is 32 blocks of a cancellation-heavy shell
    (masses over seven decades): the TwoSum block sums land closer to the
    float64 sum than the fp32 ones, as the reference's do."""
    rng = np.random.default_rng(8)
    nb, block = 32, 128
    P = nb * block
    tpos = (rng.standard_normal((1, 8, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((P, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (P, 1))
    mass = rng.uniform(1e-6, 10.0, P)
    case = (tpos, np.arange(8, dtype=np.int32)[None],
            src.astype(np.float32), mass.astype(np.float32),
            np.full(P, -1, np.int32), np.asarray([[0, 0, 0, nb]], np.int32))
    d = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(d, axis=-1)).sum(-1)
    errs = {}
    for comp in (False, True):
        _, p = pool.eval_pool_plain(*_torch(case), P, 0.0, 1.0, block,
                                    compensated=comp, mode="pot")
        _, pj = pk.eval_pool(*(jnp.asarray(a) for a in case), P, 0.0, 1.0,
                             block, compensated=comp, mode="pot",
                             interpret=True)
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-6)
        errs[comp] = np.abs(p.numpy().astype(np.float64) - pot_ref).max()
    assert errs[True] < errs[False]


def test_fused_wrapper_rejects_cpu_tensors():
    t = _torch(make_case(4))
    with pytest.raises(ValueError, match="CUDA"):
        pool.eval_pool_fused(*t[:6], WINDOW, 0.0, 1.0, BLOCK)
    with pytest.raises(ValueError, match="CUDA"):
        pool.eval_pool_fused(*t[:6], WINDOW, 0.0, 1.0, BLOCK,
                             compensated=True, pool_quad=t[6])


def test_pool_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A host with no CUDA toolkit gets an error, not a fallback."""
    if shared.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(shared, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        shared.build_library("pool")
