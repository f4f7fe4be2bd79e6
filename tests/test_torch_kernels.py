"""The shared-candidate pairwise evaluation of rakau_tpu_torch on CPU
tensors (the plain PyTorch version, directly and through dispatch)
against rakau_tpu's Pallas kernel in interpret mode and its XLA
reference, on the same float32 inputs. Tolerance rtol 2e-4, atol 2e-5:
the bound tests/test_pallas.py holds the Pallas kernel to.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it
against the plain version there. Here: its wrapper's input checks and
its active-block plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu.kernels import pallas as pk
from rakau_tpu.kernels import xla as xk
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, shared

RTOL, ATOL = 2e-4, 2e-5


def make_case(seed, C=4, T=32, S=384, eps=0.01):
    """Targets and one shared source row with planted self pairs, far
    massless padding, a dead stretch of 64-blocks and an empty tile."""
    rng = np.random.default_rng(seed)
    n = 2000
    tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int32)
    tidx[1, -3:] = n                                    # padding targets
    spos = rng.standard_normal((S, 3)).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = rng.integers(-1, n, S).astype(np.int32)
    spos[:8] = tpos[0, :8]                              # self pairs
    sidx[:8] = tidx[0, :8]
    spos[-5:] = 1e30                                    # padding sources
    smass[-5:] = 0.0
    sidx[-5:] = -1
    mask = rng.uniform(size=(C, S)) < 0.3
    mask[:, 64:192] = False
    mask[2] = False                                     # empty tile
    return tpos, tidx, spos, smass, sidx, mask, eps


def _torch_args(case):
    tpos, tidx, spos, smass, sidx, mask, _ = case
    return (torch.as_tensor(tpos), torch.as_tensor(tidx.astype(np.int64)),
            torch.as_tensor(spos), torch.as_tensor(smass),
            torch.as_tensor(sidx.astype(np.int64)), torch.as_tensor(mask))


def _jax_args(case):
    tpos, tidx, spos, smass, sidx, mask, _ = case
    return tuple(jnp.asarray(a) for a in (tpos, tidx, spos, smass, sidx,
                                          mask))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("S,eps", [(384, 0.01), (333, 0.0)])
def test_plain_matches_pallas_and_xla(mode, S, eps):
    case = make_case(S, S=S, eps=eps)
    targs = _torch_args(case)
    jargs = _jax_args(case)
    got = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64)
    want_p = pk.eval_shared_fused(*jargs, eps, 1.5, block=64,
                                  interpret=True, mode=mode)
    want_x = xk.eval_shared(*jargs, eps, 1.5, block=64, mode=mode)
    _close(got, want_p)
    _close(got, want_x)
    assert not got[0][2].any() and not got[1][2].any()     # empty tile
    disp = dispatch.eval_shared(TreeConfig(), *targs, eps, 1.5, mode=mode)
    _close(disp, want_x)


def test_plain_block_size_does_not_change_the_sums():
    targs = _torch_args(make_case(1))
    a = shared.eval_shared_plain(*targs, 0.01, 1.0, block=64)
    b = shared.eval_shared_plain(*targs, 0.01, 1.0, block=1000)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_active_blocks_lists_live_blocks_in_order():
    B = shared.BLOCK
    S = 4 * B + B // 3                                  # a ragged last block
    rng = np.random.default_rng(2)
    mask = torch.as_tensor(rng.uniform(size=(4, S)) < 1e-3)
    mask[:, B:2 * B] = False                            # a dead block
    mask[1] = False                                     # an empty tile
    mask[3, -1] = True                                  # live ragged tail
    ids, cnt = shared.active_blocks(mask)
    nb = -(-S // B)
    assert ids.shape == (4, nb) and ids.dtype == torch.int32
    for c in range(4):
        live = [b for b in range(nb) if mask[c, b * B:(b + 1) * B].any()]
        assert cnt[c] == len(live)
        assert ids[c, :len(live)].tolist() == live
        assert (ids[c, len(live):] == nb).all()
    assert cnt[1] == 0 and nb - 1 in ids[3].tolist()


def test_fused_wrapper_rejects_cpu_tensors():
    targs = _torch_args(make_case(3))
    with pytest.raises(ValueError, match="CUDA"):
        shared.eval_shared_fused(*targs, 0.0, 1.0)


def test_dispatch_refuses_compensated_accumulation():
    targs = _torch_args(make_case(4))
    with pytest.raises(NotImplementedError):
        dispatch.eval_shared(TreeConfig(accum="compensated"), *targs,
                             0.0, 1.0)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A host with no CUDA toolkit gets an error, not a fallback."""
    if shared.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(shared, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        shared.build_library()
