"""Imported sources (the LET imports): rakau_tpu_torch.engine
.acc_pot_u_host(extra=(pos, mass)) against
jax.jit(rakau_tpu.engine.acc_pot_u)(..., extra=) on the same JAX-built
tree and the same 256 imports, at N=2048 with the configuration of
__graft_entry__.dryrun_multichip: shared with "local" (the far/near gate
takes them into the tile expansions), "m2p" and "grid2" (appended, at cell
-1), and lmac + "m2p" + quadrupole. The overflow flags equal (at caps that
do not overflow: the port's lmac flags also carry its candidate table),
forces and potentials within 1e-5 relative RMS, as the port's other engine
tests hold them. gwalk refuses imports as the reference does; the lists
path, whose reference branch drops them, raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import engine as jengine
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu_torch import engine
from rakau_tpu_torch.convert import config_from_jax, treedata_from_numpy

torch.set_num_threads(1)

N, E = 2048, 256
THETA, EPS, BOX = 0.75, 0.05, 64.0
DRYRUN = dict(max_depth=6, max_leaf_n=16, ncrit=32, tile_chunk=8,
              m2p_cap=512, p2p_leaf_cap=256, p2p_src_cap=2048,
              frontier_cap=512)
CASES = {
    "shared+local": dict(),
    "shared+m2p": dict(farfield="m2p"),
    "shared+grid2": dict(farfield="grid2", grid_level=3, local_order=3,
                         grid_sep=2),
    "lmac+m2p+quad": dict(traversal_mode="lmac", farfield="m2p",
                          multipole_order=2, frontier_cap=4096),
}
jax_build = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
jax_query = jax.jit(jengine.acc_pot_u, static_argnames=("cfg",))


def _data():
    rng = np.random.default_rng(23)
    u = rng.uniform(1e-6, 1 - 1e-6, N)
    r = np.minimum(1.0 / np.sqrt(u ** (-2.0 / 3.0) - 1.0), 10.0)
    v = rng.standard_normal((N, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = (v * r[:, None]).astype(np.float32)
    mass = np.full(N, 1.0 / N, np.float32)
    # imports: half spread through the cloud's core (near most tiles),
    # half on a far shell (into the tile expansions with "local")
    w = rng.standard_normal((E, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    rad = np.concatenate([rng.uniform(0.05, 2.0, E // 2),
                          rng.uniform(15.0, 25.0, E - E // 2)])
    e_pos = (w * rad[:, None]).astype(np.float32)
    e_mass = rng.uniform(0.5, 1.5, E).astype(np.float32) / N
    return pos, mass, e_pos, e_mass


def _rms(a, ref):
    a = np.asarray(a, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    rel = np.linalg.norm(a - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-300)
    return float(np.sqrt(np.mean(rel ** 2)))


def _port_tree(jc):
    pos, mass, _, _ = _data()
    jtd = jax_build(jnp.asarray(pos), jnp.asarray(mass), jc,
                    box_size=jnp.float32(BOX))
    td = treedata_from_numpy(
        {k: np.asarray(v) for k, v in jtd._asdict().items()}, "cpu")
    return jtd, td


@pytest.mark.parametrize("case", sorted(CASES))
def test_imports_match_jax(case):
    _, _, e_pos, e_mass = _data()
    jc = JaxConfig(**{**DRYRUN, **CASES[case]})
    jtd, td = _port_tree(jc)
    a_j, p_j, o_j = jax_query(jtd, jc, jnp.float32(THETA), jnp.float32(EPS),
                              1.0, extra=(jnp.asarray(e_pos),
                                          jnp.asarray(e_mass)))
    a, p, o, _ = engine.acc_pot_u_host(
        td, config_from_jax(jc), THETA, EPS, 1.0,
        extra=(torch.tensor(e_pos), torch.tensor(e_mass)))
    assert not np.asarray(o_j).any()
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    assert _rms(a, a_j) <= 1e-5
    assert _rms(p, p_j) <= 1e-5
    # the imports moved the answer: the same query without them differs
    a0, _, _, _ = engine.acc_pot_u_host(td, config_from_jax(jc), THETA,
                                        EPS, 1.0)
    assert _rms(a0, a_j) > 1e-3


def test_gwalk_refuses_imports():
    jc = JaxConfig(**{**DRYRUN, "traversal_mode": "gwalk",
                      "farfield": "m2p"})
    _, td = _port_tree(JaxConfig(**DRYRUN))
    _, _, e_pos, e_mass = _data()
    with pytest.raises(NotImplementedError):
        engine.acc_pot_u_host(td, config_from_jax(jc), THETA, EPS, 1.0,
                              extra=(torch.tensor(e_pos),
                                     torch.tensor(e_mass)))


def test_lists_refuses_imports(diag_modes):
    jc = JaxConfig(**{**DRYRUN, "traversal_mode": "lists",
                      "farfield": "m2p"})
    _, td = _port_tree(JaxConfig(**DRYRUN))
    _, _, e_pos, e_mass = _data()
    with pytest.raises(ValueError, match="lists"):
        engine.acc_pot_u_host(td, config_from_jax(jc), THETA, EPS, 1.0,
                              extra=(torch.tensor(e_pos),
                                     torch.tensor(e_mass)))
