"""rakau_tpu_torch.parallel.let on BASELINE config #4's particles: a
uniform cube (benchmarks/configs.py:191) on config #4's tree shape
(max_depth 10, max_leaf_n 64, ncrit 256: configs.py:192-193), 8,192
particles on 4 and 8 CPU shards, in both phase-0 modes.

The export counts and the export overflow of the port's acc_pot_let are
held exactly to the reference's: each shard's export walk as
rakau_tpu/parallel/let.py:_export_query runs it (the reference's build of
the shard's rows, rakau_tpu.traversal2.build_shared_sources with the
domain boxes as tiles, compacted into export_cap slots), on the rows the
port's pipeline built that shard's tree from, and the exchange's
overflow by the NumPy transcription of the reference's routing
(tests/test_torch_let.py:_route_np). The whole reference pipeline is not
run here: its acc_pot_let takes minutes a call on the CPU mesh (the
Plummer comparison, tests/test_torch_let.py, is `slow`). The sums are
held to the float64 direct sum with tests/test_let.py's tolerances:
force RMS below max(1.5 x the port's single-device query's, 2e-3),
potential RMS below 5e-3, the two phase-0 modes within 3e-3 of each
other.

The cube's Morton-range domain boxes overlap as a Plummer sphere's do:
the sample-sort splitters (and the equal ranges of phase0 "global") cut
a few cells off a neighbour's range, whose bounding box spans it, so a
shard exports about its whole range to that neighbour (the counts below,
~1.0 x the range at every size on the cube).

The imports' far field split over the import rows (engine.IMPORT_BLOCK)
is held to the one-step sum on the same chunk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu import build as jbuild
from rakau_tpu import morton as jmorton
from rakau_tpu import particles as jparticles
from rakau_tpu import scan_utils as jsu
from rakau_tpu import traversal2 as jt2
from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.parallel import let as jlet
from rakau_tpu_torch import build, engine, integrate
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.direct import direct_acc_pot_np
from rakau_tpu_torch.parallel import let, sharded

from .helpers import rel_vec_err, rms
from .test_torch_let import _route_np

torch.set_num_threads(1)

N, THETA, EPS = 8192, 0.75, 0.0
# config #4's tree shape; caps that hold every row at this N; chunks of 16
# tiles (a query's chunking changes which tiles share a row, not what each
# sums), which keeps the CPU's plain pairwise sums to a few seconds a shard
CFG_KW = dict(max_depth=10, max_leaf_n=64, ncrit=256, tile_chunk=16,
              p2p_leaf_cap=2048, p2p_src_cap=8192, m2p_cap=1024)
CFG = TreeConfig(**CFG_KW)
# the power of two above the largest export count (2,037-2,048 of a
# shard's 2,048 rows at 4 shards, 1,024-1,035 of 1,024 at 8)
EXPORT_CAP = {4: 4096, 8: 2048}
WALK_CAPS = (8192, 32768, 4096, 1024)        # acc_pot_let's defaults
SLACK, SAMPLES = 2.0, 128                      # acc_pot_let's defaults
_CACHE = {}


def _cube():
    """N particles uniform in config #4's cube (0.999 of a unit box), mass
    1/N each, float32 from a seed."""
    rng = np.random.default_rng(19)
    return (rng.uniform(-0.4995, 0.4995, (N, 3)).astype(np.float32),
            np.full(N, 1.0 / N, np.float32))


def _direct():
    if "direct" not in _CACHE:
        pos, mass = _cube()
        _CACHE["direct"] = direct_acc_pot_np(pos.astype(np.float64),
                                             mass.astype(np.float64), eps=EPS)
    return _CACHE["direct"]


def _single_device_error():
    """Force RMS of the port's single-device query against the direct
    sum."""
    if "one" not in _CACHE:
        pos, mass = (torch.tensor(a) for a in _cube())
        acc, _, ovf = integrate.acc_pot(pos, mass, CFG, THETA, EPS)
        assert not ovf.any()
        _CACHE["one"] = rms(rel_vec_err(acc.numpy(), _direct()[0]))
    return _CACHE["one"]


def _let(ndev, phase0, monkeypatch):
    """acc_pot_let on the cube (with_stats), with the rows each shard's
    tree was built from (build.build_tree recorded)."""
    rows = []

    def recorded(p, m, cfg, box_size=None):
        rows.append((p, m, box_size))
        return build_tree(p, m, cfg, box_size)
    build_tree = build.build_tree
    monkeypatch.setattr(build, "build_tree", recorded)
    pos, mass = (torch.tensor(a) for a in _cube())
    out = let.acc_pot_let(pos, mass, CFG, THETA, EPS, 1.0,
                          sharded.default_mesh(ndev, device="cpu"),
                          export_cap=EXPORT_CAP[ndev], phase0=phase0,
                          with_stats=True)
    monkeypatch.undo()
    assert len(rows) == ndev
    return out, rows


def _reference_exports(rows, ndev, phase0):
    """The reference's export counts [ndev, ndev] and export overflow of
    the shards' trees over `rows`: each shard's domain box over its valid
    rows (distributed; every row with "global", as the reference's
    _acc_pot_let_global bounds them), its walk against the other
    (nonempty) domains, compacted into EXPORT_CAP slots."""
    jc = JaxConfig(**CFG_KW)
    jc_q = jlet._query_cfg(jc)
    jc_e = jlet._export_cfg(jc, *WALK_CAPS)
    build_j = jax.jit(jbuild.build_tree, static_argnames=("cfg",))
    walk_j = jax.jit(jt2.build_shared_sources, static_argnames=("cfg",))
    valid = [np.asarray(m.numpy() > 0) if phase0 == "distributed"
             else np.ones(m.shape[0], bool) for _, m, _ in rows]
    pts = [p.numpy() for p, _, _ in rows]
    dlo = np.stack([p[v].min(0) for p, v in zip(pts, valid)])
    dhi = np.stack([p[v].max(0) for p, v in zip(pts, valid)])
    ne = np.array([v.any() for v in valid])
    cnts, ovf = [], False
    for me, (p, m, box) in enumerate(rows):
        jtd = build_j(jnp.asarray(p.numpy()), jnp.asarray(m.numpy()), jc_q,
                      box_size=jnp.float32(float(box)))
        not_me = (np.arange(ndev) != me) & ne
        src = walk_j(jtd, jc_e, jnp.float32(THETA), jnp.asarray(dlo),
                     jnp.asarray(dhi), tile_valid=jnp.asarray(not_me))
        _, cnt = jsu.compact_indices(src.mask, EXPORT_CAP[ndev])
        cnt = np.asarray(cnt)
        ovf |= bool(np.any(cnt > EXPORT_CAP[ndev])
                    or np.asarray(src.overflow).any())
        cnts.append(cnt)
    return np.stack(cnts), ovf


def _routing_overflow(ndev):
    """The reference's exchange overflow (distributed phase 0) on the
    cube: its routing, transcribed in NumPy on (hi, lo) Morton words of
    each shard's sorted rows."""
    pos, _ = _cube()
    nl = N // ndev
    cap = max(1, -(-int(nl * SLACK) // ndev))
    box = float(np.asarray(jparticles.auto_box_size(jnp.asarray(pos))))
    hi_s, lo_s = [], []
    for r in range(ndev):
        cells = jparticles.discretize(jnp.asarray(pos[r * nl:(r + 1) * nl]),
                                      box, CFG.max_depth)
        hi, lo = (np.asarray(w) for w in jmorton.encode(cells, 3,
                                                        CFG.max_depth))
        order = np.lexsort((lo, hi))
        hi_s.append(hi[order])
        lo_s.append(lo[order])
    return any(x for _, _, x in _route_np(hi_s, lo_s, nl, cap,
                                           min(SAMPLES, nl)))


@pytest.mark.parametrize("phase0", ["distributed", "global"])
@pytest.mark.parametrize("ndev", [4, 8])
def test_let_on_the_cube_matches_the_reference(ndev, phase0, monkeypatch):
    (acc, pot, ovf, exp_ovf, cnt), rows = _let(ndev, phase0, monkeypatch)
    assert not ovf.any()
    cnt_ref, ovf_ref = _reference_exports(rows, ndev, phase0)
    if phase0 == "distributed":
        ovf_ref |= _routing_overflow(ndev)
    np.testing.assert_array_equal(cnt.numpy(), cnt_ref)
    assert bool(exp_ovf) == ovf_ref and not ovf_ref
    # the overlapping domain boxes: some shard exports about its range
    assert cnt.max() > 0.9 * (N // ndev)
    acc_d, pot_d = _direct()
    e_let = rms(rel_vec_err(acc.numpy(), acc_d))
    assert e_let < max(1.5 * _single_device_error(), 2e-3), e_let
    assert rms((pot.numpy() - pot_d) / pot_d) < 5e-3
    other = _CACHE.setdefault(("acc", ndev), {})
    other[phase0] = acc.numpy()
    if len(other) == 2:
        assert rms(rel_vec_err(other["distributed"], other["global"])) < 3e-3


def test_import_far_field_split_matches_one_step(monkeypatch):
    """One chunk of config #4's cube with E imported rows: the imports'
    gate and M2L taken IMPORT_BLOCK rows a step against the one step over
    all of them (the reference's), on the same chunk: the near mask and
    the row exactly equal, the chunk's sums within float32 rounding of
    the far sums' order."""
    pos, mass = (torch.tensor(a) for a in _cube())
    rng = np.random.default_rng(23)
    E = 1000
    extra = (torch.tensor(rng.uniform(-1.5, 1.5, (E, 3)).astype(np.float32)),
             torch.tensor(rng.uniform(0, 2.0 / N, E).astype(np.float32)))
    td = build.build_tree(pos, mass, CFG)
    tiles, tables, Lgrid = engine._query_state(td, CFG, EPS)
    (tpos, tidx, blo, bhi, tcell), _ = engine._chunk_tiles(tiles, 0)
    theta, eps, scal = engine.scalars(td.pos, THETA, EPS, 1.0)

    def chunk():
        src, mask, acc_l, pot_l = engine._chunk_sources(
            td, CFG, theta, eps, scal, tpos, tidx, blo, bhi, tables, tcell,
            Lgrid, extra=extra)
        acc, pot, ovf, _ = engine._eval_chunk(
            td, CFG, theta, eps, scal, tpos, tidx, blo, bhi, tables, tcell,
            Lgrid, extra=extra)
        assert not ovf.any()
        return src, mask, acc_l, pot_l, acc, pot

    one = chunk()
    monkeypatch.setattr(engine, "IMPORT_BLOCK", 64)      # 16 steps
    split = chunk()
    assert torch.equal(one[1], split[1])
    assert all(torch.equal(a, b) for a, b in zip(one[0], split[0])
               if isinstance(a, torch.Tensor))
    far = one[1][:, -E:].logical_not() & (tidx[:, :1] < N)
    assert far.any() and one[1][:, -E:].any()            # both paths taken
    for a, b in zip(one[2:], split[2:]):
        scale = a.abs().max()
        assert (a - b).abs().max() <= 1e-5 * scale
