"""TreeConfig.kernel_backend in rakau_tpu_torch's dispatch, as the
reference reads it (rakau_tpu/kernels/dispatch.py): "auto" takes the hand
kernel on CUDA tensors and the plain version on CPU tensors, "xla" the
plain version on either device, "pallas" the kernel, raising ValueError on
CPU tensors. Checked for the shared, gwalk and lists queries at N=2048:
"pallas" raises on the CPU, "xla" equals "auto" bit for bit there, and
with the tensors taken for card tensors (dispatch._on_card patched) and
every CUDA wrapper made to raise, "xla" never reaches a wrapper while
"auto" does."""
import numpy as np
import pytest
import torch

from rakau_tpu_torch import build, engine
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, pool, shared, tiles

torch.set_num_threads(1)

N = 2048
THETA = 0.75
SMALL = dict(max_depth=10, max_leaf_n=16, ncrit=64, tile_chunk=8,
             m2p_cap=2048, p2p_leaf_cap=512, p2p_src_cap=4096,
             frontier_cap=512)
CASES = {
    "shared+grid": dict(SMALL, farfield="grid", grid_level=3),
    "gwalk+grid": dict(max_depth=9, max_leaf_n=16, ncrit=64, tile_chunk=8,
                       m2p_cap=16384, p2p_leaf_cap=12288,
                       p2p_src_cap=131072, frontier_cap=2048,
                       pool_window=32768, pool_block=128, pool_group=2,
                       traversal_mode="gwalk", farfield="grid",
                       grid_level=3),
    "lists+m2p": dict(SMALL, traversal_mode="lists", farfield="m2p"),
}
_TREES = {}


def _tree(case):
    if case not in _TREES:
        rng = np.random.default_rng(5)
        u = rng.uniform(1e-6, 1 - 1e-6, N)
        r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
        v = rng.standard_normal((N, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pos = torch.tensor((v * r[:, None]).astype(np.float32))
        mass = torch.full((N,), 1.0 / N)
        _TREES[case] = build.build_tree(pos, mass, TreeConfig(**CASES[case]))
    return _TREES[case]


def _query(case, backend):
    cfg = TreeConfig(**CASES[case], kernel_backend=backend)
    return engine.acc_pot_u_host(_tree(case), cfg, THETA, 0.01)


@pytest.fixture(params=sorted(CASES))
def case(request, monkeypatch):
    if request.param.startswith("lists"):
        monkeypatch.setenv("RAKAU_DIAG_MODES", "1")
    return request.param


def test_pallas_on_cpu_tensors_raises(case):
    with pytest.raises(ValueError, match="pallas"):
        _query(case, "pallas")


def test_xla_equals_auto_bit_for_bit_on_cpu(case):
    a_auto, p_auto, o_auto, m_auto = _query(case, "auto")
    a_xla, p_xla, o_xla, m_xla = _query(case, "xla")
    assert not o_auto.any()
    assert torch.equal(a_xla, a_auto) and torch.equal(p_xla, p_auto)
    assert torch.equal(o_xla, o_auto) and torch.equal(m_xla, m_auto)


def test_xla_never_reaches_a_cuda_wrapper(case, monkeypatch):
    want = _query(case, "auto")

    def refuse(*a, **kw):
        raise AssertionError("a CUDA wrapper was reached")

    monkeypatch.setattr(dispatch, "_on_card", lambda t: True)
    for mod, name in ((shared, "eval_shared_fused"),
                      (pool, "eval_pool_fused"),
                      (tiles, "eval_tiles_fused")):
        monkeypatch.setattr(mod, name, refuse)
    got = _query(case, "xla")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the patch is live: the same query under "auto" reaches the wrapper
    with pytest.raises(AssertionError, match="CUDA wrapper"):
        _query(case, "auto")
