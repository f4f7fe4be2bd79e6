"""The accuracy ladder's rungs (`chip_smoke.ACC_RUNGS`, benchmarks/
ladder.py's configuration as group `accuracy` runs it at 1,048,576
particles on the card) on a small Plummer sphere through both packages'
`engine.acc_pot_u_host`, for tests/test_torch_ladder.py (orders 4 and
6), tests/test_torch_ladder_o8.py and tests/test_torch_ladder_o8s4.py
(order 8): one JAX-built tree handed
to the port through rakau_tpu_torch.convert, then each package's query
and its errors against the float64 direct sum at every particle.

The sizes are cut so that the reference's executables compile in time
on one CPU core: N particles, ncrit and tile_chunk small, the leaf grid
at level 2 (4 cells a side). Every other field, the caps among them, is
the rung's. The reference's order-8 far field takes ~130 s to compile
at one grid level (its T tensors of order 16), so each order-8 rung has
a file of its own, and at level 2 rung e's separation of 4 cells leaves
no pair in its far field: the port's order-8, 4-cell far field is held
to the float64 direct sum at level 3 by tests/test_torch_grid2.py, and
on the card at 1,048,576 by group accuracy."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import Tree, engine
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy
from rakau_tpu_torch.direct import direct_acc_pot_np

torch.set_num_threads(1)

N = 2048
SMALL = dict(ncrit=128, tile_chunk=16)
GRID_LEVEL = 2
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))


def plummer_np(n: int, seed: int = 19):
    """A Plummer-like sphere (radii clipped at 10), float32, equal
    masses."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(1e-6, 1 - 1e-6, n)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return ((v * r[:, None]).astype(np.float32),
            np.full(n, 1.0 / n, np.float32))


@lru_cache(maxsize=None)
def oracle():
    pos, mass = plummer_np(N)
    return direct_acc_pot_np(pos, mass)


def rms_errors(acc, pot) -> tuple:
    """(force RMS, potential RMS) relative to the float64 direct sum, at
    every particle (acc and pot in user order)."""
    acc_o, pot_o = oracle()
    f = (np.linalg.norm(np.asarray(acc, np.float64) - acc_o, axis=1)
         / np.linalg.norm(acc_o, axis=1))
    p = np.abs(np.asarray(pot, np.float64) - pot_o) / np.abs(pot_o)
    return float(np.sqrt(np.mean(f ** 2))), float(np.sqrt(np.mean(p ** 2)))


def rung_config(name: str) -> dict:
    return dict(chip_smoke.rung_kw(name), **SMALL, grid_level=GRID_LEVEL)


@lru_cache(maxsize=None)
def port_rung(name: str) -> dict:
    """The port alone on rung `name` (its own build), for a bound that
    reads a rung whose sums another file holds to the reference's."""
    pos, mass = plummer_np(N)
    tree = Tree(coords=pos, masses=mass, device="cpu",
                config=config_from_jax(JaxConfig(**rung_config(name))))
    acc, pot = tree.accs_pots_o(chip_smoke.ACC_RUNGS[name][3])
    return dict(zip(("force_rms", "pot_rms"), rms_errors(acc, pot)))


@lru_cache(maxsize=None)
def both_rung(name: str) -> dict:
    """Rung `name` through rakau_tpu and the port on one JAX-built tree:
    each one's Morton-order sums, flags and maxima, and its errors."""
    theta = chip_smoke.ACC_RUNGS[name][3]
    jc = JaxConfig(**rung_config(name))
    pos, mass = plummer_np(N)
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc)
    a_j, p_j, o_j, m_j = jengine.acc_pot_u_host(
        jtd, jc, jnp.float32(theta), jnp.float32(0.0), 1.0)
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    a, p, o, m = engine.acc_pot_u_host(td, config_from_jax(jc), theta, 0.0,
                                       1.0)
    inv = np.asarray(jtd.inv_perm)
    out = {"ref": dict(acc=np.asarray(a_j), pot=np.asarray(p_j),
                       flags=np.asarray(o_j), maxima=np.asarray(m_j)),
           "port": dict(acc=a.numpy(), pot=p.numpy(), flags=o.numpy(),
                        maxima=m.numpy())}
    for side in out.values():
        side["force_rms"], side["pot_rms"] = rms_errors(side["acc"][inv],
                                                        side["pot"][inv])
    return out


def check_rung(name: str):
    """Rung `name`: no flag set, flags and maxima exactly equal, sums
    finite and within rtol 2e-5 / atol 1e-6 of the largest (the kernels
    and the convolutions sum in other orders), the two packages' errors
    against the direct sum within 1 % of each other."""
    res = both_rung(name)
    ref, port = res["ref"], res["port"]
    assert not ref["flags"].any()
    np.testing.assert_array_equal(port["flags"], ref["flags"])
    np.testing.assert_array_equal(port["maxima"], ref["maxima"])
    for k in ("acc", "pot"):
        assert np.isfinite(port[k]).all() and np.isfinite(ref[k]).all()
        np.testing.assert_allclose(
            port[k], ref[k], rtol=2e-5,
            atol=1e-6 * float(np.abs(ref[k]).max()))
    for k in ("force_rms", "pot_rms"):
        assert abs(port[k] - ref[k]) <= 0.01 * ref[k]
    return res
