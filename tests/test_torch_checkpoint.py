"""rakau_tpu_torch.checkpoint: a tree saved by the port reloads with the
same config and results, a file written by rakau_tpu.checkpoint loads in
the port (the same .npz layout), the state round trip, and the default
device rule of load_tree."""
import numpy as np
import pytest
import torch

from rakau_tpu import Tree as JaxTree
from rakau_tpu import checkpoint as jcheckpoint
from rakau_tpu_torch import Tree, checkpoint
from rakau_tpu_torch.convert import config_from_jax

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

CFG = dict(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)


def _data(n=1024, seed=41):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    return pos, mass


def test_tree_round_trip(tmp_path):
    pos, mass = _data()
    t = Tree(coords=pos, masses=mass, farfield="m2p", multipole_order=2,
             accum="compensated", device="cpu", **CFG)
    p = str(tmp_path / "tree.npz")
    checkpoint.save_tree(p, t)
    t2 = checkpoint.load_tree(p, device="cpu")
    assert t2.config == t.config and t2.box_size == t.box_size
    np.testing.assert_array_equal(t2.positions_o.numpy(), pos)
    np.testing.assert_array_equal(t2.masses_o.numpy(), mass)
    a1, p1 = t.accs_pots_o(0.5)
    a2, p2 = t2.accs_pots_o(0.5)
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(p1.numpy(), p2.numpy())


def test_a_reference_file_loads_in_the_port(tmp_path):
    pos, mass = _data(seed=42)
    jt = JaxTree(coords=pos, masses=mass, **CFG)
    p = str(tmp_path / "jax_tree.npz")
    jcheckpoint.save_tree(p, jt)
    t = checkpoint.load_tree(p, device="cpu")
    assert t.config == config_from_jax(jt.config)
    assert t.box_size == pytest.approx(jt.box_size, rel=1e-7)
    np.testing.assert_array_equal(t.positions_o.numpy(),
                                  np.asarray(jt.positions_o))
    acc = t.accs_o(0.5).numpy()
    jacc = np.asarray(jt.accs_o(theta=0.5))
    rel = np.linalg.norm(acc - jacc, axis=1) / np.linalg.norm(jacc, axis=1)
    assert float(np.sqrt(np.mean(rel ** 2))) <= 1e-5


def test_state_round_trip(tmp_path):
    p = str(tmp_path / "state.npz")
    pos = torch.as_tensor(np.random.default_rng(0).standard_normal((100, 3)))
    checkpoint.save_state(p, pos, pos * 0, torch.ones(100), step=7)
    st = checkpoint.load_state(p)
    np.testing.assert_array_equal(st["positions"], pos.numpy())
    np.testing.assert_array_equal(st["velocities"], np.zeros((100, 3)))
    np.testing.assert_array_equal(st["masses"], np.ones(100))
    assert int(st["step"]) == 7
    # and a state written by the reference reads the same
    q = str(tmp_path / "jax_state.npz")
    jcheckpoint.save_state(q, pos.numpy(), pos.numpy() * 0, np.ones(100),
                           step=7)
    jst = checkpoint.load_state(q)
    assert sorted(jst) == sorted(st)
    for k in st:
        np.testing.assert_array_equal(jst[k], st[k])


def test_load_tree_defaults_to_the_card(tmp_path, monkeypatch):
    pos, mass = _data(64)
    p = str(tmp_path / "tree.npz")
    checkpoint.save_tree(p, Tree(coords=pos, masses=mass, device="cpu",
                                 **CFG))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.load_tree(p)
