"""The shared-candidate pairwise evaluation of rakau_tpu_torch on CPU
tensors (the plain PyTorch version, directly and through dispatch)
against rakau_tpu's Pallas kernel in interpret mode and its XLA
reference, on the same float32 inputs, in the monopole, compensated and
quadrupole forms, each also with the grid2 cell-separation test (K1c).
Tolerance rtol 2e-4, atol 2e-5: the bound tests/test_pallas.py holds the
Pallas kernel to.

The two other evaluators of the row likewise: the plain tensor-core form
(K6) against the reference's matrix-unit kernel in interpret mode at each
of its precisions (x3 and highest at the same tolerance, one bf16 pass at
rtol 2e-2: 2^-8 a pair), the plain split-source form (K5) against
`pallas.eval_shared` and the XLA reference, and dispatch's selector.

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against the plain versions there. Here: the wrappers' input checks and
the active-block plan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rakau_tpu.config import TreeConfig as JaxConfig
from rakau_tpu.kernels import dispatch as jdispatch
from rakau_tpu.kernels import pallas as pk
from rakau_tpu.kernels import xla as xk
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.kernels import dispatch, shared

# pytest-xdist runs one worker per core; torch's own intra-op pool in
# every worker would oversubscribe the cores (tens of times slower).
torch.set_num_threads(1)

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


@pytest.mark.parametrize("quad", [False, True])
@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
def test_plain_block_size_does_not_change_the_sums(mode, quad):
    """Neither the granule nor the span length (K1's plan) changes the
    sums beyond rounding, in every mode, monopole or quadrupole (the
    compensated forms: tests/test_torch_k1_plan.py)."""
    kw = dict(mode=mode)
    if quad:
        case, q = make_quad_case(1)
        kw["src_quad"] = torch.as_tensor(q)
    else:
        case = make_case(1)
    targs = _torch_args(case)
    a = shared.eval_shared_plain(*targs, 0.01, 1.0, block=64, **kw)
    for block, span in ((1000, shared.SPAN), (64, 0), (32, 1),
                        (shared.GRANULE, shared.SPAN), (256, 3)):
        b = shared.eval_shared_plain(*targs, 0.01, 1.0, block=block,
                                     span=span, **kw)
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


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A host with no CUDA toolkit gets an error, not a fallback."""
    if shared.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has a CUDA toolkit")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(shared, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        shared.build_library()


def make_quad_case(seed, C=4, T=32, S=192, eps=0.01):
    """Node rows (idx -1) near the targets with plausible raw second
    moments Q = m d d^T, a dead 64-block, and one masked-out node row
    1e-9 from a target, where inv_r^5 overflows fp32 at eps = 0."""
    rng = np.random.default_rng(seed)
    n = 2000
    tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int32)
    spos = (2.0 + rng.standard_normal((S, 3))).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = np.full(S, -1, np.int32)
    mask = rng.uniform(size=(C, S)) < 0.4
    mask[:, 64:128] = False
    d = rng.standard_normal((S, 3)) * 0.1
    quad = (np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(3)],
                     1) * smass[:, None]).astype(np.float32)
    tpos[1, 3] = (1e-3, -2e-3, 5e-4)
    spos[5] = tpos[1, 3] + np.float32(1e-9)  # on a target, masked out
    mask[1, 5] = False
    mask[0, 5] = True
    return (tpos, tidx, spos, smass, sidx, mask, eps), quad


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("comp", [False, True])
def test_plain_quad_matches_pallas_and_xla(mode, comp):
    case, quad = make_quad_case(5)
    eps = case[-1]
    targs, jargs = _torch_args(case), _jax_args(case)
    got = shared.eval_shared_plain(*targs, 0.0, 1.5, mode=mode, block=64,
                                   compensated=comp,
                                   src_quad=torch.as_tensor(quad))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    got = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64,
                                   compensated=comp,
                                   src_quad=torch.as_tensor(quad))
    jq = jnp.asarray(quad)
    want_p = pk.eval_shared_fused(*jargs, eps, 1.5, block=64, mode=mode,
                                  interpret=True, compensated=comp,
                                  src_quad=jq)
    want_x = xk.eval_shared(*jargs, eps, 1.5, block=64, mode=mode,
                            compensated=comp, src_quad=jq)
    _close(got, want_p)
    _close(got, want_x)
    # the quadrupole correction changes the answer
    mono = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64,
                                    compensated=comp)
    k = 1 if mode == "pot" else 0
    assert (got[k] - mono[k]).abs().max() > 1e-6


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
def test_plain_compensated_matches_pallas_and_xla(mode):
    case = make_case(6)
    eps = case[-1]
    targs, jargs = _torch_args(case), _jax_args(case)
    got = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64,
                                   compensated=True)
    _close(got, pk.eval_shared_fused(*jargs, eps, 1.5, block=64, mode=mode,
                                     interpret=True, compensated=True))
    _close(got, xk.eval_shared(*jargs, eps, 1.5, block=64, mode=mode,
                               compensated=True))


def test_compensated_sum_is_closer_to_float64():
    """A long, cancellation-heavy source row (far shell, masses over seven
    decades): the TwoSum block sums land at least as close to the float64
    sum as the plain fp32 ones, and agree with the reference's."""
    rng = np.random.default_rng(8)
    C, T, S = 1, 8, 4096
    tpos = (rng.standard_normal((C, T, 3)) * 0.01).astype(np.float32)
    tidx = np.arange(T, dtype=np.int32)[None]
    dirs = rng.standard_normal((S, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (S, 1))
    mass = rng.uniform(1e-6, 10.0, S)
    case = (tpos, tidx, src.astype(np.float32), mass.astype(np.float32),
            np.full(S, -1, np.int32), np.ones((C, S), bool), 0.0)
    d = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(d, axis=-1)).sum(-1)
    errs = {}
    for comp in (False, True):
        _, p = shared.eval_shared_plain(*_torch_args(case), 0.0, 1.0,
                                        mode="pot", block=128,
                                        compensated=comp)
        _, pj = xk.eval_shared(*_jax_args(case), 0.0, 1.0, block=128,
                               mode="pot", compensated=comp)
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-6)
        errs[comp] = np.abs(p.numpy().astype(np.float64) - pot_ref).max()
    assert errs[True] <= errs[False]


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("accum", ["fp32", "compensated"])
def test_dispatch_splits_quad_and_particle_rows_like_jax(mode, accum):
    """dispatch.eval_shared with src_quad for the first U rows: the
    quadrupole form on [0, U), the monopole form on [U, S), summed."""
    case = make_case(9, S=320)
    qcase, quad = make_quad_case(9, S=128)
    # node rows first, then particle rows, one mask row per tile
    case = tuple(np.concatenate([q, c], axis=-1 if k == 5 else 0)
                 if k in (2, 3, 4, 5) else c
                 for k, (q, c) in enumerate(zip(qcase, case)))
    eps = case[-1]
    cfg = TreeConfig(accum=accum)
    got = dispatch.eval_shared(cfg, *_torch_args(case), eps, 1.5, mode=mode,
                               src_quad=torch.as_tensor(quad))
    want = jdispatch.eval_shared(JaxConfig(accum=accum), *_jax_args(case),
                                 eps, 1.5, mode=mode,
                                 src_quad=jnp.asarray(quad))
    _close(got, want)


def test_dispatch_returns_zeros_for_an_empty_source_row():
    tpos, tidx, spos, smass, sidx, mask, _ = make_case(10)
    empty = (tpos, tidx, spos[:0], smass[:0], sidx[:0], mask[:, :0], 0.0)
    acc, pot = dispatch.eval_shared(TreeConfig(accum="compensated"),
                                    *_torch_args(empty), 0.0, 1.0)
    assert acc.shape == tpos.shape and pot.shape == tpos.shape[:2]
    assert not acc.any() and not pot.any()


def test_fused_wrapper_checks_the_quad_operand():
    targs = _torch_args(make_case(11))
    with pytest.raises(ValueError, match="CUDA"):
        shared.eval_shared_fused(*targs, 0.0, 1.0, compensated=True,
                                 src_quad=torch.zeros(384, 6))


# ------------------------------------------- K1c: the cell-separation test
def make_cells(seed, C, T, S, G=8):
    """Leaf-grid cells for a case: pairs on both sides of grid_sep 2 and
    3, exempt source rows (-1), and a planted self pair that is covered
    too (targets 0..7 of tile 0 are also sources 0..7)."""
    rng = np.random.default_rng(seed)
    tcell = rng.integers(0, G, (C, T, 3)).astype(np.int32)
    scell = rng.integers(0, G, (S, 3)).astype(np.int32)
    scell[20:40] = -1                                   # exempt rows
    scell[:4] = (tcell[0, :4] + 5) % G                  # covered self pairs
    return scell, tcell


def _brute_cell_mask(mask, scell, tcell, sep):
    """[C, T, S] mask with the covered pairs taken out
    (tests/test_pallas.py:222-237)."""
    csep = np.abs(scell[None, None].astype(np.int64)
                  - tcell[:, :, None].astype(np.int64)).max(-1)
    covered = (csep >= sep) & (scell[None, None, :, 0] >= 0)
    return mask[:, None, :] & ~covered


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("sep", [2, 3])
@pytest.mark.parametrize("comp", [False, True])
def test_plain_cells_match_pallas_xla_and_bruteforce(mode, sep, comp):
    case = make_case(20 + sep, S=333, eps=0.01)
    eps = case[-1]
    C, T, S = case[0].shape[0], case[0].shape[1], case[2].shape[0]
    scell, tcell = make_cells(sep, C, T, S)
    targs, jargs = _torch_args(case), _jax_args(case)
    tkw = dict(src_cell=torch.as_tensor(scell).long(),
               tgt_cell=torch.as_tensor(tcell).long(), grid_sep=sep)
    jkw = dict(src_cell=jnp.asarray(scell), tgt_cell=jnp.asarray(tcell),
               grid_sep=sep)
    got = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64,
                                   compensated=comp, **tkw)
    _close(got, pk.eval_shared_fused(*jargs, eps, 1.5, block=128, mode=mode,
                                     interpret=True, compensated=comp,
                                     **jkw))
    _close(got, xk.eval_shared(*jargs, eps, 1.5, block=64, mode=mode,
                               compensated=comp, **jkw))
    # int32 cells give the same sums as int64 ones
    got32 = shared.eval_shared_plain(
        *targs, eps, 1.5, mode=mode, block=64, compensated=comp,
        src_cell=torch.as_tensor(scell), tgt_cell=torch.as_tensor(tcell),
        grid_sep=sep)
    assert torch.equal(got[0], got32[0]) and torch.equal(got[1], got32[1])
    # brute force: every target its own tile, the covered pairs masked out
    tpos, tidx, spos, smass, sidx, mask, _ = case
    pm = _brute_cell_mask(mask, scell, tcell, sep).reshape(C * T, S)
    flat = (torch.as_tensor(tpos.reshape(C * T, 1, 3)),
            torch.as_tensor(tidx.reshape(C * T, 1).astype(np.int64)),
            targs[2], targs[3], targs[4], torch.as_tensor(pm))
    want = shared.eval_shared_plain(*flat, eps, 1.5, mode=mode, block=64,
                                    compensated=comp)
    _close((got[0].reshape(C * T, 1, 3), got[1].reshape(C * T, 1)), want)
    # the test removes pairs: the answer differs from the untested sum
    free = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64)
    k = 1 if mode == "pot" else 0
    assert (got[k] - free[k]).abs().max() > 1e-3


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("comp", [False, True])
def test_plain_quad_cells_match_pallas_and_xla(mode, comp):
    case, quad = make_quad_case(31)
    eps = case[-1]
    C, T, S = case[0].shape[0], case[0].shape[1], case[2].shape[0]
    scell, tcell = make_cells(31, C, T, S)
    targs, jargs = _torch_args(case), _jax_args(case)
    tkw = dict(src_cell=torch.as_tensor(scell).long(),
               tgt_cell=torch.as_tensor(tcell).long(), grid_sep=2,
               src_quad=torch.as_tensor(quad))
    jkw = dict(src_cell=jnp.asarray(scell), tgt_cell=jnp.asarray(tcell),
               grid_sep=2, src_quad=jnp.asarray(quad))
    # the masked-out node on a target at eps = 0 stays finite
    got = shared.eval_shared_plain(*targs, 0.0, 1.5, mode=mode, block=64,
                                   compensated=comp, **tkw)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    got = shared.eval_shared_plain(*targs, eps, 1.5, mode=mode, block=64,
                                   compensated=comp, **tkw)
    _close(got, pk.eval_shared_fused(*jargs, eps, 1.5, block=128, mode=mode,
                                     interpret=True, compensated=comp,
                                     **jkw))
    _close(got, xk.eval_shared(*jargs, eps, 1.5, block=64, mode=mode,
                               compensated=comp, **jkw))


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("accum", ["fp32", "compensated"])
def test_dispatch_with_cells_and_quad_split_like_jax(mode, accum):
    """dispatch.eval_shared with cells: alone, and with src_quad for the
    first U rows, where src_cell[:U] goes with the node rows and
    src_cell[U:] with the particle rows."""
    case = make_case(40, S=320)
    qcase, quad = make_quad_case(40, S=128)
    both = tuple(np.concatenate([q, c], axis=-1 if k == 5 else 0)
                 if k in (2, 3, 4, 5) else c
                 for k, (q, c) in enumerate(zip(qcase, case)))
    eps = case[-1]
    for cs, q in ((case, None), (both, quad)):
        C, T, S = cs[0].shape[0], cs[0].shape[1], cs[2].shape[0]
        scell, tcell = make_cells(41, C, T, S)
        got = dispatch.eval_shared(
            TreeConfig(accum=accum, farfield="grid2", grid_sep=2),
            *_torch_args(cs), eps, 1.5, mode=mode,
            src_quad=None if q is None else torch.as_tensor(q),
            src_cell=torch.as_tensor(scell).long(),
            tgt_cell=torch.as_tensor(tcell).long())
        want = jdispatch.eval_shared(
            JaxConfig(accum=accum, farfield="grid2", grid_sep=2),
            *_jax_args(cs), eps, 1.5, mode=mode,
            src_quad=None if q is None else jnp.asarray(q),
            src_cell=jnp.asarray(scell), tgt_cell=jnp.asarray(tcell))
        _close(got, want)


def test_cell_operands_are_checked():
    targs = _torch_args(make_case(12))
    scell, tcell = make_cells(1, 4, 32, 384)
    with pytest.raises(ValueError, match="tgt_cell"):
        shared.eval_shared_plain(*targs, 0.0, 1.0, grid_sep=2,
                                 src_cell=torch.as_tensor(scell))
    with pytest.raises(ValueError, match="grid_sep"):
        shared.eval_shared_fused(*targs, 0.0, 1.0,
                                 src_cell=torch.as_tensor(scell),
                                 tgt_cell=torch.as_tensor(tcell))
    with pytest.raises(ValueError, match="CUDA"):
        shared.eval_shared_fused(*targs, 0.0, 1.0, grid_sep=2,
                                 src_cell=torch.as_tensor(scell),
                                 tgt_cell=torch.as_tensor(tcell))
    # every fused form has its name; the row's other two evaluators theirs
    assert set(shared.FORMS) == {
        shared.form_name(q, c, g) for q in (False, True)
        for c in (False, True) for g in (False, True)} | {
            "mma", "mma_cell", "blocks"}


def _packed_far(scell, tcell, sep, D):
    """The packed cell test of csrc/cell_test.cuh in int64 NumPy: [S, T],
    source s and target t belong to the dense far field. D fields of
    30 // D bits; a negative first source coordinate exempts the row."""
    bits = 30 // D
    top = 1 << (bits - 1)

    def pack(cols):
        w = np.zeros(np.shape(cols[0]), np.int64)
        for c in cols:
            w = (w << bits) | c
        return w

    pc = np.where(scell[:, 0] >= 0, pack([scell[:, d] for d in range(D)]),
                  -1)
    tk = pack([top + sep - 1 - tcell[:, d] for d in range(D)])
    cb = pack([np.int64(top + 1 - 2 * sep)] * D)
    v = pc[:, None] + tk[None]
    x = (v & pack([np.int64(top - 1)] * D)) + cb
    return (pc[:, None] >= 0) & (((~v | x) & pack([np.int64(top)] * D)) != 0)


def _grid2_level_cap(D):
    """The deepest grid2 grid_level that TreeConfig admits in D dims."""
    level = 0
    while True:
        try:
            TreeConfig(ndim=D, farfield="grid2", grid_level=level + 1)
        except ValueError:
            return level
        level += 1


@pytest.mark.parametrize("D", [2, 3])
def test_packed_cell_test_holds_every_grid2_level(D):
    """The kernels' packed cell test (two 15-bit fields in 2-D, three
    10-bit ones in 3-D) agrees with the Chebyshev separation on every
    coordinate below 2^CELL_BITS[D], which covers every grid2 level the
    configuration admits (10 in 2-D, 7 in 3-D); a deeper grid, or a wider
    separation, is refused before any launch."""
    bits = shared.CELL_BITS[D]
    assert _grid2_level_cap(D) <= bits
    shared.check_cell_level(bits, D)
    with pytest.raises(ValueError, match="leaf-grid levels"):
        shared.check_cell_level(bits + 1, D)
    rng = np.random.default_rng(31 + D)
    top = 1 << bits
    for sep in (2, 3, 7, top // 2, top):
        tcell = rng.integers(0, top, (256, D))
        tcell[0], tcell[1] = 0, top - 1          # both ends of the range
        near = tcell[rng.integers(0, 256, 2048)]
        scell = np.clip(near + rng.integers(-sep - 1, sep + 2, (2048, D)), 0,
                        top - 1)
        scell[-64:] = rng.integers(0, top, (64, D))
        scell[100:120] = -1
        cheb = np.abs(scell[:, None] - tcell[None]).max(-1)
        want = (cheb >= sep) & (scell[:, None, 0] >= 0)
        got = _packed_far(scell, tcell, sep, D)
        np.testing.assert_array_equal(got, want)
        if sep < top:
            assert want.any() and (~want).any()
    sc = torch.zeros((4, D), dtype=torch.int32)
    tc = torch.zeros((1, 2, D), dtype=torch.int32)
    assert shared._check_cells(sc, tc, top, D) == top
    with pytest.raises(ValueError, match="grid_sep"):
        shared._check_cells(sc, tc, top + 1, D)


# ------------------------------------------------- K6, the tensor-core form
def make_mma_case(seed, C=4, T=32, S=384):
    """make_case with source indices that mark the planted self pairs
    only: the matrix-unit form drops pairs by distance, not by index, so a
    random index that happens to equal a target's would be dropped by the
    fused form alone. The softening is 0.25: the norm trick leaves a
    rounding residue of ~2^-24 (|t'|^2 + |s'|^2) in r^2, which two
    implementations round differently, and on these unclustered points
    (local coordinates up to ~5) a pair at r ~ 0.05 would turn it into
    ~1e-3 of its force; with r^2 + eps^2 >= 0.06 it stays under 1e-4."""
    tpos, tidx, spos, smass, sidx, mask, _ = make_case(seed, C=C, T=T, S=S)
    sidx[8:] = -1
    return tpos, tidx, spos, smass, sidx, mask, 0.25


def make_mma_tile_case(seed, C=4, T=32, S=333, D=3):
    """A row for K6 whose tiles are compact, as the engine's are: each
    tile's targets in a unit cube, the sources spread around them, so that
    |Y| stays within a few |acc| (on make_mma_case's unclustered rows |Y|
    is up to ~100 |acc|, and the reference's own fp32 sums of Y then lie
    1.07-1.33x the tolerance from the exact sum of the same terms at
    blocks of 128-512, where the plain version's lie 0.24x). Planted self
    pairs (tile 0, targets 0..7), far massless padding, a dead stretch of
    granules and an empty tile (2); softening 0.25 (make_mma_case)."""
    rng = np.random.default_rng(seed)
    n = 2000
    centers = rng.uniform(-2, 2, (C, 1, D))
    tpos = (centers + rng.uniform(-0.5, 0.5, (C, T, D))).astype(np.float32)
    tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int32)
    tidx[1, -3:] = n                                    # padding targets
    spos = rng.uniform(-3, 3, (S, D)).astype(np.float32)
    smass = rng.uniform(0.1, 1, S).astype(np.float32)
    sidx = np.full(S, -1, np.int32)
    spos[:8] = tpos[0, :8]                              # self pairs
    sidx[:8] = tidx[0, :8]
    spos[-5:] = 1e30                                    # padding sources
    smass[-5:] = 0.0
    mask = rng.uniform(size=(C, S)) < 0.3
    mask[:, 64:192] = False
    mask[2] = False                                     # empty tile
    return tpos, tidx, spos, smass, sidx, mask, 0.25


# The plain K6 follows K1's plan; against the reference's matrix-unit
# kernel with the granule as its `subblock` (its step a block of 256
# sources made of them), each mode runs it at one granule, at every span
# length: (granule, spans)
MMA_PLANS = {"both": (shared.GRANULE, (0, 1, 3)), "acc": (64, (0, 1, 3)),
             "pot": (32, (0, 1, 3))}


def _mma_close(got, want, prec):
    """K6 against the reference's matrix-unit kernel: RTOL/ATOL, one bf16
    pass at 2e-2 (2^-8 a pair)."""
    rtol = 2e-2 if prec == "bf16" else RTOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=ATOL if prec != "bf16" else 2e-2)


def _mma_cells(seed, S, D=3):
    """(torch, jax) keyword arguments of make_cells' leaf cells in D
    dimensions at grid_sep 2."""
    scell, tcell = make_cells(seed, 4, 32, S)
    scell, tcell = scell[:, :D].copy(), tcell[..., :D].copy()
    return (dict(src_cell=torch.as_tensor(scell).long(),
                 tgt_cell=torch.as_tensor(tcell).long(), grid_sep=2),
            dict(src_cell=jnp.asarray(scell), tgt_cell=jnp.asarray(tcell),
                 grid_sep=2))


@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "x3", "highest"])
def test_plain_mma_matches_the_pallas_mxu_kernel(monkeypatch, prec, cells,
                                                 mode):
    """At each precision, with and without cells: the plain K6 at granules
    of 64 in one span against the reference's kernel at blocks of 64 on
    make_mma_case's rows; then at its mode's granule (MMA_PLANS: 128, 64,
    32) and every span length against the reference with that granule as
    its `subblock`, on compact tiles (make_mma_tile_case)."""
    case = make_mma_case(61, S=333)
    eps = case[-1]
    targs, jargs = _torch_args(case), _jax_args(case)
    tkw, jkw = _mma_cells(62, 333) if cells else ({}, {})
    monkeypatch.setenv("RAKAU_PALLAS_MXU", "1")
    monkeypatch.setenv("RAKAU_MXU_PREC", prec)
    want = pk.eval_shared_fused(*jargs, eps, 1.5, block=64, interpret=True,
                                mode=mode, **jkw)
    got = shared.eval_shared_mma_plain(*targs, eps, 1.5, mode=mode,
                                       prec=prec, granule=64, span=0, **tkw)
    _mma_close(got, want, prec)
    assert not got[0][2].any() and not got[1][2].any()      # empty tile

    case = make_mma_tile_case(61, S=333)
    targs, jargs = _torch_args(case), _jax_args(case)
    granule, spans = MMA_PLANS[mode]
    want = pk.eval_shared_fused(*jargs, eps, 1.5, block=256,
                                subblock=granule, interpret=True, mode=mode,
                                **jkw)
    off = targs[5].clone()
    off[0, 0] = False
    for span in spans:
        plan = dict(mode=mode, prec=prec, granule=granule, span=span, **tkw)
        got = shared.eval_shared_mma_plain(*targs, eps, 1.5, **plan)
        _mma_close(got, want, prec)
        assert not got[0][2].any() and not got[1][2].any()  # empty tile
        # the planted self pairs (tile 0, targets 0..7) add nothing:
        # without them target (0, 0) keeps its sums bit for bit
        bare = shared.eval_shared_mma_plain(*targs[:5], off, eps, 1.5,
                                            **plan)
        assert torch.equal(bare[0][0, 0], got[0][0, 0])
        assert torch.equal(bare[1][0, 0], got[1][0, 0])


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "x3", "highest"])
def test_plain_mma_matches_the_pallas_mxu_kernel_in_2d(monkeypatch, prec,
                                                       cells):
    """The same in 2-D (2-D cells too) on compact tiles, at a granule of
    64 and every span length, mode both."""
    case = make_mma_tile_case(70, S=300, D=2)
    eps = case[-1]
    targs, jargs = _torch_args(case), _jax_args(case)
    tkw, jkw = _mma_cells(71, 300, D=2) if cells else ({}, {})
    monkeypatch.setenv("RAKAU_PALLAS_MXU", "1")
    monkeypatch.setenv("RAKAU_MXU_PREC", prec)
    want = pk.eval_shared_fused(*jargs, eps, 1.5, block=256, subblock=64,
                                interpret=True, **jkw)
    for span in (0, 1, 3):
        got = shared.eval_shared_mma_plain(*targs, eps, 1.5, prec=prec,
                                           granule=64, span=span, **tkw)
        assert got[0].shape == (4, 32, 2)
        _mma_close(got, want, prec)
        assert not got[0][2].any() and not got[1][2].any()  # empty tile


# the plans of test_plain_mma_plans_do_not_change_the_sums: (granule, span)
MMA_PLAN_GRID = ((32, 1), (64, 0), (shared.GRANULE, shared.SPAN), (256, 3),
                 (1000, shared.SPAN))


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("mode", ["both", "acc", "pot"])
@pytest.mark.parametrize("prec", ["bf16", "x3", "highest"])
def test_plain_mma_plans_do_not_change_the_sums(prec, mode, cells):
    """Neither the granule nor the span length changes the plain K6's sums
    beyond the reordering of fp32 sums: every per-pair term (w3, its
    bfloat16 parts and their products, exact in fp32) is the same at every
    plan. Tolerance rtol 1e-5, and an absolute 2e-5 of the largest
    acceleration (acc = Y - ysum t' cancels: |Y| is up to 10-100x |acc|
    in a tile, so the rounding of Y's sums, ~1e-7 of |Y|, shows at up to
    1e-5 of acc; measured 0.8-2.5e-6 here) or 1e-6 of the largest
    potential (a plain sum; measured 2.4e-7)."""
    case = make_mma_case(72, S=700)
    eps = case[-1]
    targs = _torch_args(case)
    kw = dict(mode=mode, prec=prec)
    if cells:
        scell, tcell = make_cells(73, 4, 32, 700)
        kw.update(src_cell=torch.as_tensor(scell).long(),
                  tgt_cell=torch.as_tensor(tcell).long(), grid_sep=2)
    a = shared.eval_shared_mma_plain(*targs, eps, 1.0, granule=64, span=1,
                                     **kw)
    for granule, span in MMA_PLAN_GRID:
        b = shared.eval_shared_mma_plain(*targs, eps, 1.0, granule=granule,
                                         span=span, **kw)
        for x, y, atol in zip(b, a, (2e-5, 1e-6)):
            np.testing.assert_allclose(
                x.numpy(), y.numpy(), rtol=1e-5,
                atol=atol * float(y.abs().max()))


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("prec", ["bf16", "x3", "highest"])
def test_plain_mma_self_pairs_add_nothing_at_every_plan(prec, cells):
    """The planted self pairs (tile 0, targets 0..7 on sources 0..7) are
    dead at every granule and span: with the mask of source 0 on tile 0
    switched off, target (0, 0) keeps its sums bit for bit, in every
    mode."""
    case = make_mma_case(74, S=500)
    eps = case[-1]
    targs = _torch_args(case)
    kw = {}
    if cells:
        scell, tcell = make_cells(75, 4, 32, 500)
        kw = dict(src_cell=torch.as_tensor(scell).long(),
                  tgt_cell=torch.as_tensor(tcell).long(), grid_sep=3)
    off = targs[5].clone()
    off[0, 0] = False
    for granule in (32, 64, 128):
        for span in (0, 1, 3):
            for mode in ("both", "acc", "pot"):
                plan = dict(granule=granule, span=span, mode=mode, prec=prec,
                            **kw)
                got = shared.eval_shared_mma_plain(*targs, eps, 1.5, **plan)
                bare = shared.eval_shared_mma_plain(*targs[:5], off, eps,
                                                    1.5, **plan)
                assert torch.equal(bare[0][0, 0], got[0][0, 0])
                assert torch.equal(bare[1][0, 0], got[1][0, 0])
                assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize("prec,tol", [("highest", 1e-4), ("x3", 1e-4),
                                      ("bf16", 5e-2)])
def test_plain_mma_agrees_with_the_fused_form_on_a_tile(prec, tol):
    """Another arithmetic, the same physics: on a compact tile with its
    sources around it (where the norm trick's noise stays at rounding
    level) the tensor-core form gives the fused form's sums."""
    rng = np.random.default_rng(63)
    C, T, S = 2, 48, 300
    tpos = (rng.uniform(-0.5, 0.5, (C, T, 3))
            + np.array([3.0, -2.0, 1.0])).astype(np.float32)
    tidx = np.arange(C * T).reshape(C, T)
    spos = (rng.uniform(-2, 2, (S, 3))
            + np.array([3.0, -2.0, 1.0])).astype(np.float32)
    spos[:T] = tpos[0]                                    # tile 0 itself
    sidx = np.full(S, -1)
    sidx[:T] = tidx[0]
    args = (torch.as_tensor(tpos), torch.as_tensor(tidx),
            torch.as_tensor(spos),
            torch.as_tensor(rng.uniform(0.1, 1, S).astype(np.float32)),
            torch.as_tensor(sidx), torch.as_tensor(
                rng.uniform(size=(C, S)) < 0.7))
    want = shared.eval_shared_plain(*args, 0.05, 1.0)
    got = shared.eval_shared_mma_plain(*args, 0.05, 1.0, prec=prec)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < tol


def test_mma_operands_are_checked():
    targs = _torch_args(make_mma_case(64))
    with pytest.raises(ValueError, match="prec"):
        shared.eval_shared_mma_plain(*targs, 0.0, 1.0, prec="tf32")
    with pytest.raises(ValueError, match="mode"):
        shared.eval_shared_mma_plain(*targs, 0.0, 1.0, mode="force")
    with pytest.raises(ValueError, match="tgt_cell"):
        shared.eval_shared_mma_plain(
            *targs, 0.0, 1.0, src_cell=torch.zeros((384, 3),
                                                   dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        shared.eval_shared_mma(*targs, 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        shared.eval_shared_blocks(*targs, 0.0, 1.0)


# ----------------------------------------------- K5, the block-plan form
@pytest.mark.parametrize("span", [1, 2, 6])
def test_plain_blocks_matches_pallas_shared_and_xla(span):
    case = make_case(65)
    eps = case[-1]
    targs, jargs = _torch_args(case), _jax_args(case)
    got = shared.eval_shared_blocks_plain(*targs, eps, 1.5, block=64,
                                          span=span)
    want_p = pk.eval_shared(*jargs, eps, 1.5, block=64, interpret=True)
    want_x = xk.eval_shared(*jargs, eps, 1.5, block=64)
    _close(got, want_p)
    _close(got, want_x)
    assert not got[0][2].any() and not got[1][2].any()      # empty tile
    # the spans only regroup the per-block sums, and the mask as a weight
    # gives the dead gate's sums
    one = shared.eval_shared_plain(*targs, eps, 1.5, block=64)
    for g, w in zip(got, one):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="span"):
        shared.eval_shared_blocks_plain(*targs, eps, 1.5, block=64, span=0)


def test_blocks_plan_is_fused_plan_at_the_block():
    """K5's plan is K1's plan at the reference's block: fused_plan(mask,
    BLOCKS_SPAN, BLOCK), whose lists, counts and spans here follow a brute
    force over a mask with an empty tile, a full tile, a tile whose only
    live entry lies in the ragged last block and a long list."""
    B = shared.BLOCK
    S = 6 * B + 300                                     # a ragged last block
    rng = np.random.default_rng(71)
    mask = torch.as_tensor(rng.uniform(size=(5, S)) < 2e-3)
    mask[1] = False                                     # empty
    mask[2] = True                                      # full
    mask[3] = False
    mask[3, -1] = True                                  # ragged tail only
    mask[4, ::B // 2] = True                            # every block
    nb = -(-S // B)
    for span in (shared.BLOCKS_SPAN, 1, 2, 4):
        plan = shared.fused_plan(mask, span, B)
        assert plan.zmax == -(-nb // span)
        work = []
        for c in range(5):
            live = [b for b in range(nb) if mask[c, b * B:(b + 1) * B].any()]
            assert plan.cnt[c] == len(live)
            assert plan.ids[c, :len(live)].tolist() == live
            assert (plan.ids[c, len(live):] == nb).all()
            work += [c * plan.zmax + z for z in range(-(-len(live) // span))]
        assert plan.n_work.item() == len(work)
        assert plan.work[:len(work)].tolist() == work
        assert (plan.work[len(work):] == 5 * plan.zmax).all()
    plan = shared.fused_plan(mask, shared.BLOCKS_SPAN, B)
    assert plan.cnt[1:].tolist() == [0, nb, 1, nb]
    assert plan.ids[3, 0] == nb - 1


def test_block_any_is_the_plan_of_every_form():
    """K5 plans at BLOCK; K1 and K6 at GRANULE (fused_plan)."""
    mask = torch.zeros((3, 2500), dtype=torch.bool)
    mask[0, 5] = mask[0, 2050] = mask[1, 1024] = True
    assert shared.PLAN_BLOCK["blocks"] == shared.BLOCK
    assert shared.PLAN_BLOCK["mma"] == shared.PLAN_BLOCK["fused"] \
        == shared.GRANULE
    any_ = shared.block_any(mask)
    assert any_.tolist() == [[True, False, True], [False, True, False],
                             [False, False, False]]
    ids, cnt = shared.active_blocks(mask)
    assert cnt.tolist() == any_.sum(1).tolist()
    assert ids[0, :2].tolist() == [0, 2] and ids[1, 0] == 1
    G = shared.GRANULE
    assert shared.PLAN_BLOCK["fused"] == G
    k1 = shared.fused_plan(mask)
    assert k1.ids.shape == (3, -(-2500 // G))
    assert k1.cnt.tolist() == shared.block_any(mask, G).sum(1).tolist() \
        == [2, 1, 0]
    assert k1.ids[0, :2].tolist() == [0, 2050 // G]
    assert k1.ids[1, 0] == 1024 // G


# ------------------------------------------------------------ the selector
SEL_CFG = TreeConfig(farfield="m2p")


def test_selector_routes_cpu_tensors_to_the_selected_plain_version():
    case = make_mma_case(66)
    eps = case[-1]
    targs = _torch_args(case)
    fused = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0)
    with dispatch.shared_variant("mma", prec="bf16"):
        got = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0, mode="acc")
        want = shared.eval_shared_mma_plain(*targs, eps, 1.0, mode="acc",
                                            prec="bf16")
        assert torch.equal(got[0], want[0]) and not got[1].any()
        assert not torch.equal(got[0], fused[0])
        with dispatch.shared_variant("blocks"):
            got = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0)
            want = shared.eval_shared_blocks_plain(*targs, eps, 1.0)
            assert torch.equal(got[0], want[0])
        # the outer selection is back
        again = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0, mode="acc")
        assert torch.equal(again[0], shared.eval_shared_mma_plain(
            *targs, eps, 1.0, mode="acc", prec="bf16")[0])
    back = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0)
    assert torch.equal(back[0], fused[0]) and torch.equal(back[1], fused[1])
    # the default precision is x3
    with dispatch.shared_variant("mma"):
        got = dispatch.eval_shared(SEL_CFG, *targs, eps, 1.0)
    want = shared.eval_shared_mma_plain(*targs, eps, 1.0, prec="x3")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_selector_mma_leaves_compensated_and_quadrupole_to_the_fused_form():
    case, quad = make_quad_case(67)
    eps = case[-1]
    targs = _torch_args(case)
    comp_cfg = TreeConfig(farfield="m2p", accum="compensated")
    quad_cfg = TreeConfig(farfield="m2p", multipole_order=2)
    U = 64
    q = torch.as_tensor(quad[:U])
    want_c = dispatch.eval_shared(comp_cfg, *targs, eps, 1.0)
    want_q = dispatch.eval_shared(quad_cfg, *targs, eps, 1.0, src_quad=q)
    with dispatch.shared_variant("mma", prec="highest"):
        got_c = dispatch.eval_shared(comp_cfg, *targs, eps, 1.0)
        got_q = dispatch.eval_shared(quad_cfg, *targs, eps, 1.0, src_quad=q)
    # compensated: the fused form, bit for bit
    assert torch.equal(got_c[0], want_c[0]) and torch.equal(got_c[1],
                                                            want_c[1])
    # quadrupole: the node rows [0, U) stay fused, the particle rows go to
    # the tensor-core form
    a_n, p_n = shared.eval_shared_plain(
        *targs[:2], *(t[:U] for t in targs[2:5]),
        targs[5][:, :U].contiguous(), eps, 1.0, src_quad=q)
    a_p, p_p = shared.eval_shared_mma_plain(
        *targs[:2], *(t[U:] for t in targs[2:5]),
        targs[5][:, U:].contiguous(), eps, 1.0, prec="highest")
    assert torch.equal(got_q[0], a_p + a_n) and torch.equal(got_q[1],
                                                            p_p + p_n)
    _close(got_q, [w.numpy() for w in want_q])


def test_selector_refuses_what_a_variant_does_not_compute():
    case = make_mma_case(68)
    eps = case[-1]
    targs = _torch_args(case)
    scell, tcell = make_cells(69, 4, 32, 384)
    cells = dict(src_cell=torch.as_tensor(scell).long(),
                 tgt_cell=torch.as_tensor(tcell).long())
    with pytest.raises(ValueError, match="variant"):
        with dispatch.shared_variant("mxu"):
            pass
    with pytest.raises(ValueError, match="prec"):
        with dispatch.shared_variant("mma", prec="tf32"):
            pass
    with dispatch.shared_variant("blocks"):
        for cfg, kw in ((SEL_CFG, dict(mode="acc")),
                        (TreeConfig(farfield="m2p", accum="compensated"), {}),
                        (TreeConfig(farfield="grid2", local_order=3), cells),
                        (TreeConfig(farfield="m2p", multipole_order=2),
                         dict(src_quad=torch.zeros((64, 6))))):
            with pytest.raises(ValueError, match="blocks"):
                dispatch.eval_shared(cfg, *targs, eps, 1.0, **kw)
    # a failed call inside the block leaves the default selected
    assert dispatch._variant == ("fused", "x3")
