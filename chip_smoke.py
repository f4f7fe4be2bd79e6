#!/usr/bin/env python3
"""Drive the PyTorch port (rakau_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--n N] [--seed S]

Phases, each printing one JSON line:
  1. device:   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build:    nvcc builds the pairwise kernel from csrc/ (timed);
  3. edge:     kernel vs plain PyTorch on small random cases in every form
               (K1a monopole, K1b compensated, K1d quadrupole, K1d with
               K1b's sums) and mode (self pairs, far padding, an empty
               tile, ragged T and S, a masked-out node row on top of a
               target); on a long cancellation-heavy row the compensated
               kernel's error against a float64 sum must be < the fp32
               kernel's (equal errors would mean fp32 sums);
  4. main:     a Plummer sphere of N particles (default 1,048,576) from a
               seeded CUDA generator, octree(...) with the headline
               shared+grid configuration, accs_pots_o(theta=0.75) once
               cold and three times warm (median and spread reported);
               the kernel's launch count over each warm query must equal
               the number of chunks it evaluated;
  5. layers:   one more warm query with the walk, the walk + far field and
               the kernel call each timed between device syncs;
  6. profile:  one more warm query under torch.profiler (CUDA activity
               only): device ops, device-busy ms (union of the device
               intervals), the kernel's device ms and the idle share;
  7. kernel:   kernel vs plain PyTorch on the first two chunks of that
               query (the same targets, shared sources and masks), every
               mode, rtol 2e-4 and atol 2e-5*max|plain|, both timed;
  8. accuracy: 256 sampled targets against the float64 NumPy direct sum:
               RMS relative force error < 5e-3, potential < 2e-3;
  9. leapfrog: BASELINE config #2 (benchmarks/configs.py:90-114) through
               rakau_tpu_torch.integrate: a cold sphere of N particles
               (--n, default 1,048,576), zero velocities, 3 steps of
               leapfrog_step_morton_safe at theta=0.75 (farfield "local"),
               energies E0 and E3 from total_energy with the quadrupole +
               compensated m2p configuration at theta=0.25, its caps sized
               first through the Tree API's grow-and-retry. Checks: finite
               results, drift |E3 - E0| / |E0| < 2e-3, K1d+K1b and K1b
               launches each equal to the energy query's chunks, sampled
               force RMS < 1.5e-2 (the top of the reference's own error
               there) and potential RMS < 2e-3 of the step configuration,
               potential RMS < 1e-4 of the energy configuration; the same
               query with fp32 sums (K1d) is reported beside it;
 10. kernel:   K1d+K1b on the node rows [0, U) and K1b on the particle
               rows [U, S) of the energy query's first chunk (and K1d on
               the node rows) against plain PyTorch, every mode, timed.
Then the kernels' summary line (time, plain time and bound of every form),
the card line, and as the last line {"ok": true, "device": {...}}. Any
failure raises (non-zero exit) before that line. Needs a CUDA card; JAX
is not used.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager

import numpy as np
import torch

THETA = 0.75
TREE_KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
               farfield="grid", m2p_cap=9728, p2p_leaf_cap=5888,
               p2p_src_cap=47104, frontier_cap=1024)
RTOL, ATOL_REL = 2e-4, 2e-5
WARM_REPS = 3
FORCE_RMS_MAX, POT_RMS_MAX = 5e-3, 2e-3
# BASELINE config #2 (benchmarks/configs.py:90-114); N and steps are cut
LF_KW = dict(max_depth=12, max_leaf_n=32, ncrit=512, tile_chunk=32,
             p2p_leaf_cap=4096, p2p_src_cap=49152, m2p_cap=12288)
LF_EPS, LF_BOX, LF_DT, LF_THETA, LF_STEPS = 0.02, 8.0, 1e-3, 0.75, 3
E_THETA = 0.25
DRIFT_MAX, E_POT_RMS_MAX = 2e-3, 1e-4
# The step configuration on a uniform-density sphere: monopole BH at
# theta=0.75 errs there by ~1.2-1.4e-2 in force RMS in the reference
# itself (the port gives the reference's forces on this configuration,
# tests/test_torch_integrate.py), so its bound is the top of that range;
# 5e-3 is the Plummer bound
LF_FORCE_RMS_MAX, LF_POT_RMS_MAX = 1.5e-2, 2e-3
# the card's published peaks (H100 SXM, 700 W): fp32 outside the tensor
# cores and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# fp32 operations per live (source, target) pair, counted from the
# kernel's inner loop (csrc/shared_fused.cu); TwoSum adds 6 operations
# per sum per target and active source block
FLOPS_MONO, FLOPS_QUAD, FLOPS_TWOSUM = 20, 64, 24
SRC = "rakau_tpu_torch/csrc/shared_fused.cu"
REPLACES = "rakau_tpu/kernels/pallas.py:566"


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)
    torch.cuda.synchronize()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (after one warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


@contextmanager
def synced(module, name: str, totals: dict):
    """Replace module.name, for the duration, by a wrapper that adds the
    wall ms of each call, taken between device syncs, to totals[name]."""
    orig = getattr(module, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        totals[name] = totals.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, orig)


def layer_ms(tree) -> dict:
    """One warm query through the entry point, split by layer: the walk
    (traversal2.build_shared_sources), the tile far field (engine.
    _chunk_sources less the walk) and the kernel call (dispatch.
    eval_shared: active-block lists, K1a, the G scale). The rest is
    tile gathers, assembly, the overflow read and the inverse
    permutation. The syncs add to the total, which is reported too."""
    from rakau_tpu_torch import engine, traversal2
    from rakau_tpu_torch.kernels import dispatch
    t: dict = {}
    with ExitStack() as stack:
        for mod, name in ((traversal2, "build_shared_sources"),
                          (engine, "_chunk_sources"),
                          (dispatch, "eval_shared")):
            stack.enter_context(synced(mod, name, t))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree.accs_pots_o(THETA)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    walk, walk_ff = t["build_shared_sources"], t["_chunk_sources"]
    kernel = t["eval_shared"]
    return {"walk_ms": walk, "farfield_ms": walk_ff - walk,
            "kernel_call_ms": kernel, "rest_ms": total - walk_ff - kernel,
            "synced_query_ms": total}


def device_profile(tree) -> dict:
    """One warm query under torch.profiler with CUDA activity only: the
    number of device ops (kernels, copies, sets), the device-busy ms as
    the union of their intervals, and K1a's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        tree.accs_pots_o(THETA)
        stop.record()
        stop.synchronize()
    spans, k1a_us = [], 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if "shared_fused_kernel" in e.name:
            k1a_us += e.time_range.end - e.time_range.start
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return {"profiled_query_ms": start.elapsed_time(stop),
            "device_ops": len(spans), "device_busy_ms": busy_us / 1e3,
            "k1a_device_ms": k1a_us / 1e3}


def compare(got, want):
    """Max |got - want| over (acc, pot); raises past the tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError("kernel output is not finite")
        err = (g - w).abs()
        scale = float(w.abs().max())
        bound = RTOL * w.abs() + ATOL_REL * scale
        if bool((err > bound).any()):
            raise AssertionError(
                f"kernel vs plain: max err {float(err.max()):.3e} past "
                f"rtol {RTOL} + atol {ATOL_REL}*{scale:.3e}")
        worst = max(worst, float(err.max()))
    return worst


def edge_cases(shared, dev):
    """Kernel vs plain on small cases that hit every branch of the kernel,
    in every form. Returns the worst |kernel - plain| per form."""
    rng = np.random.default_rng(7)
    worst = dict.fromkeys(shared.FORMS, 0.0)

    def check(args, eps, quad=None, empty_tile=False):
        for comp in (False, True):
            form = ("quad" if quad is not None else "mono") \
                + ("_comp" if comp else "")
            for mode in ("both", "acc", "pot"):
                kw = dict(mode=mode, compensated=comp, src_quad=quad)
                got = shared.eval_shared_fused(*args, eps, 1.5, **kw)
                want = shared.eval_shared_plain(*args, eps, 1.5, **kw)
                worst[form] = max(worst[form], compare(got, want))
                if empty_tile and bool(got[0][-1].any() | got[1][-1].any()):
                    raise AssertionError(f"{form}: empty tile got a "
                                         "nonzero result")

    for C, T, S, eps in ((3, 200, 3000, 0.0), (2, 64, 1024, 0.01),
                         (1, 512, 70, 0.0)):
        n = 10000
        tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
        tidx = rng.choice(n, size=(C, T), replace=False).astype(np.int64)
        tidx[:, -5:] = n                      # padding targets
        spos = rng.standard_normal((S, 3)).astype(np.float32)
        smass = rng.uniform(0.1, 1, S).astype(np.float32)
        sidx = rng.integers(-1, n, S).astype(np.int64)
        k = min(8, S, T)
        spos[:k] = tpos[0, :k]                # self pairs, excluded by index
        sidx[:k] = tidx[0, :k]
        spos[k:2 * k] = tpos[0, :k]           # coincident, other index
        spos[-4:] = 1e30                      # far, massless padding
        smass[-4:] = 0.0
        sidx[-4:] = -1
        mask = rng.uniform(size=(C, S)) < 0.4
        mask[:, S // 3:S // 2] = False        # a dead stretch of blocks
        if C > 1:
            mask[-1] = False                  # an empty tile
        args = [torch.as_tensor(a, device=dev) for a in
                (tpos, tidx, spos, smass, sidx, mask)]
        check(args, eps, empty_tile=C > 1)

    # node rows with second moments Q = m d d^T: ragged S, a dead stretch,
    # an empty tile, and a masked-out node 1e-9 from a target at eps = 0,
    # where inv_r^5 overflows fp32 (the result must stay finite)
    for C, T, S in ((3, 200, 2500), (2, 130, 700)):
        tpos = rng.standard_normal((C, T, 3)).astype(np.float32)
        tidx = rng.choice(10000, size=(C, T), replace=False).astype(np.int64)
        spos = (1.5 + rng.standard_normal((S, 3))).astype(np.float32)
        smass = rng.uniform(0.1, 1, S).astype(np.float32)
        sidx = np.full(S, -1, np.int64)
        d = rng.standard_normal((S, 3)) * 0.1
        quad = (np.stack([d[:, a] * d[:, b] for a, b in shared.quad_pairs(3)],
                         1) * smass[:, None]).astype(np.float32)
        mask = rng.uniform(size=(C, S)) < 0.4
        mask[:, S // 3:S // 2] = False
        mask[-1] = False
        tpos[0, 3] = (1e-3, -2e-3, 5e-4)
        spos[7] = tpos[0, 3] + np.float32(1e-9)
        mask[0, 7] = False
        args = [torch.as_tensor(a, device=dev) for a in
                (tpos, tidx, spos, smass, sidx, mask)]
        check(args, 0.0, quad=torch.as_tensor(quad, device=dev),
              empty_tile=True)

    # a long, cancellation-heavy row (far shell, masses over seven
    # decades, 64 source blocks): TwoSum must beat fp32; the kernel sums in
    # a fixed order, so an equal error means it ran fp32 sums
    C, T, S = 1, 8, 65536
    tpos = (rng.standard_normal((C, T, 3)) * 0.01).astype(np.float32)
    dirs = rng.standard_normal((S, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    src = dirs * rng.uniform(5.0, 50.0, (S, 1))
    mass = rng.uniform(1e-6, 10.0, S)
    dd = src[None, None] - tpos.astype(np.float64)[:, :, None]
    pot_ref = -(mass[None, None] / np.linalg.norm(dd, axis=-1)).sum(-1)
    args = [torch.as_tensor(a, device=dev) for a in
            (tpos, np.arange(T, dtype=np.int64)[None],
             src.astype(np.float32), mass.astype(np.float32),
             np.full(S, -1, np.int64), np.ones((C, S), bool))]
    check(args, 0.0)
    errs = {}
    for comp in (False, True):
        _, p = shared.eval_shared_fused(*args, 0.0, 1.0, mode="pot",
                                        compensated=comp)
        errs[comp] = float(np.abs(p.double().cpu().numpy() - pot_ref).max())
    if not errs[True] < errs[False]:
        raise AssertionError(f"compensated error {errs[True]:.3e} >= fp32 "
                             f"error {errs[False]:.3e}")
    return worst, {"fp32": errs[False], "compensated": errs[True]}


def bound(inputs, n, quad=False, comp=False):
    """(bound_ms, bound_by): the least time the card could take for one
    call at these inputs, the larger of the bytes it must move (each input
    read once, each output written once) over the HBM rate and the
    operations its live pairs (mask-true sources x real targets of the
    n-particle tree, and TwoSum per active source block) need over the
    fp32 peak."""
    tpos, tidx, spos, smass, sidx, mask = inputs[:6]
    C, T, _ = tpos.shape
    nbytes = sum(t.numel() * t.element_size() for t in inputs[:6]
                 + ((inputs[6],) if quad else ()))
    nbytes += C * T * 4 * 4                     # acc [C, T, 3] + pot
    ntgt = (tidx < n).sum(1).double()          # padding targets carry n
    pairs = float((mask.sum(1).double() * ntgt).sum())
    flops = pairs * (FLOPS_QUAD if quad else FLOPS_MONO)
    if comp:
        from rakau_tpu_torch.kernels import shared
        flops += FLOPS_TWOSUM * float(
            (shared.active_blocks(mask)[1].double() * ntgt).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                        else "operations")


def sampled_rms(acc, pot, acc_o, pot_o, samp, dev):
    """RMS relative force and potential errors at the sampled targets
    (acc may be None)."""
    idx = torch.as_tensor(samp, device=dev)
    p = pot[idx].double().cpu().numpy()
    p_rms = float(np.sqrt(np.mean((np.abs(p - pot_o) / np.abs(pot_o)) ** 2)))
    if acc is None:
        return None, p_rms
    a = acc[idx].double().cpu().numpy()
    f_rel = np.linalg.norm(a - acc_o, axis=1) / np.linalg.norm(acc_o, axis=1)
    return float(np.sqrt(np.mean(f_rel ** 2))), p_rms


def synced_ms(fn):
    """(fn(), wall ms) with device syncs before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def leapfrog(n: int, seed: int, dev):
    """BASELINE config #2 on the card through rakau_tpu_torch.integrate
    (phase 9). Returns the phase's record and the energy tree and config
    for the kernel phase."""
    from rakau_tpu_torch import Tree, build, direct_acc_pot_np, engine
    from rakau_tpu_torch import integrate, particles
    from rakau_tpu_torch.config import OVF_FIELDS, TreeConfig
    from rakau_tpu_torch.kernels import shared

    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.cold_sphere(n, generator=gen)
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    cfg = TreeConfig(**LF_KW)
    ecfg0 = cfg.with_(multipole_order=2, accum="compensated",
                      farfield="m2p")
    rec = {"n": n, "steps": LF_STEPS, "dt": LF_DT, "theta": LF_THETA,
           "energy_theta": E_THETA, "eps": LF_EPS, "box": LF_BOX}

    def launches_of(fn):
        """(fn(), wall ms, launches per form) with the counts set to 0
        just before the call and read just after."""
        shared.reset_launches()
        out, ms = synced_ms(fn)
        return out, ms, dict(shared.launches)

    # size the energy query's caps through the Tree API (grow and retry);
    # E3's state has moved a little, so no cap stays below 1.25x the
    # maxima this query measured (caps only grow)
    etree = Tree(coords=pos, masses=mass, config=ecfg0, box_size=LF_BOX)
    _, size_ms = synced_ms(lambda: etree.pots_o(E_THETA, LF_EPS))
    grown = etree.config
    fitted = etree.tune_caps(slack=1.25)
    ecfg = grown.with_(**{f: max(getattr(grown, f), getattr(fitted, f))
                          for f in OVF_FIELDS})
    rec.update(energy_caps_sizing_ms=size_ms,
               energy_caps_grown={f: getattr(grown, f) for f in OVF_FIELDS},
               energy_caps={f: getattr(ecfg, f) for f in OVF_FIELDS})

    def energy(st, td):
        e, ms, launches = launches_of(lambda: integrate.total_energy(
            st, ecfg, E_THETA, LF_EPS, box_size=LF_BOX))
        chunks = engine.live_chunks(td, ecfg)
        if not (launches["quad_comp"] == launches["mono_comp"] == chunks
                and launches["mono"] == launches["quad"] == 0):
            raise AssertionError(f"energy query launches {launches}, "
                                 f"chunks {chunks}")
        if not np.isfinite(e):
            raise AssertionError(f"energy {e} is not finite")
        return e, ms, chunks, launches

    e0, e0_ms, e_chunks, e_launches = energy(state, etree.tree_data)
    rec.update(e0=e0, energy_query_ms=e0_ms, energy_chunks=e_chunks,
               energy_launches=e_launches)

    step_ms, retries, caps_grown = [], 0, []
    shared.reset_launches()
    for _ in range(LF_STEPS):
        (state, ovf, _, cfg, r), ms = synced_ms(
            lambda: integrate.leapfrog_step_morton_safe(
                state, LF_DT, cfg, LF_THETA, LF_EPS, box_size=LF_BOX))
        step_ms.append(ms)
        retries += r
        if r:
            caps_grown.append({f: getattr(cfg, f) for f in OVF_FIELDS})
    step_launches = dict(shared.launches)
    if step_launches["mono"] <= 0 or any(
            step_launches[f] for f in ("mono_comp", "quad", "quad_comp")):
        raise AssertionError(f"leapfrog step launches {step_launches}")
    for t in state:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite leapfrog state")
    td, build_ms = synced_ms(lambda: build.build_tree(
        state.pos, state.mass, cfg, LF_BOX))
    _, query_ms = synced_ms(lambda: engine.acc_pot_u_host(
        td, cfg, LF_THETA, LF_EPS))
    rec.update(step_ms_median=statistics.median(step_ms), step_ms_all=step_ms,
               step_build_ms=build_ms, step_query_ms=query_ms,
               step_chunks=engine.live_chunks(td, cfg),
               cap_retries=retries, caps_grown_to=caps_grown,
               step_launches=step_launches)

    td3 = build.build_tree(state.pos, state.mass, ecfg, LF_BOX)
    e3, e3_ms, _, _ = energy(state, td3)
    drift = abs(e3 - e0) / abs(e0)
    rec.update(e3=e3, energy_query_ms_e3=e3_ms, drift=drift)

    # sampled accuracy of the final state against the float64 direct sum
    samp = np.sort(np.random.default_rng(seed + 1).choice(n, 256,
                                                          replace=False))
    acc_o, pot_o = direct_acc_pot_np(state.pos.double().cpu().numpy(),
                                     state.mass.double().cpu().numpy(),
                                     eps=LF_EPS, targets=samp)
    acc, pot, ovf = integrate.acc_pot(state.pos, state.mass, cfg, LF_THETA,
                                      LF_EPS, box_size=LF_BOX)
    f_rms, p_rms = sampled_rms(acc, pot, acc_o, pot_o, samp, dev)
    _, epot, eovf = integrate.acc_pot(state.pos, state.mass, ecfg, E_THETA,
                                      LF_EPS, box_size=LF_BOX)
    _, e_rms = sampled_rms(None, epot, None, pot_o, samp, dev)
    # the same energy query with fp32 sums (K1d), beside it
    qtree = Tree(coords=state.pos, masses=state.mass,
                 config=ecfg.with_(accum="fp32"), box_size=LF_BOX)
    qpot, q_ms, q_launches = launches_of(lambda: qtree.pots_o(E_THETA,
                                                              LF_EPS))
    _, q_rms = sampled_rms(None, qpot, None, pot_o, samp, dev)
    rec.update(force_rms=f_rms, pot_rms=p_rms, energy_pot_rms=e_rms,
               fp32_quad_pot_rms=q_rms, fp32_quad_query_ms=q_ms,
               fp32_quad_launches=q_launches)
    emit("leapfrog", **rec)
    if ovf.any() or eovf.any():
        raise AssertionError("accuracy queries overflowed their caps")
    for t in (acc, pot, epot, qpot):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite accuracy query result")
    if q_launches["quad"] <= 0 or q_launches["quad_comp"]:
        raise AssertionError(f"fp32 quadrupole launches {q_launches}")
    if not drift < DRIFT_MAX:
        raise AssertionError(f"energy drift {drift:.3e} >= {DRIFT_MAX}")
    if not (f_rms < LF_FORCE_RMS_MAX and p_rms < LF_POT_RMS_MAX
            and e_rms < E_POT_RMS_MAX):
        raise AssertionError(f"leapfrog accuracy: force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}, energy-config pot rms "
                             f"{e_rms:.3e}")
    return rec, etree, ecfg


def energy_kernels(etree, ecfg):
    """Phase 10: the energy query's first chunk, node rows [0, U) through
    K1d+K1b (and K1d) and particle rows [U, S) through K1b, against plain
    PyTorch in every mode, both timed. Returns per form (worst error,
    ms, plain_ms, bound_ms, bound_by) of mode both."""
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared
    td = etree.tree_data
    n = int(td.pos.shape[0])
    inputs = engine.kernel_inputs(td, ecfg, E_THETA, LF_EPS, 0)
    quad = inputs[6]
    U = quad.shape[0]
    nodes = tuple(t[:U] for t in inputs[2:5])
    parts = tuple(t[U:] for t in inputs[2:5])
    mask = inputs[5]
    segs = {
        "quad_comp": (inputs[:2] + nodes + (mask[:, :U].contiguous(),),
                      dict(compensated=True, src_quad=quad)),
        "quad": (inputs[:2] + nodes + (mask[:, :U].contiguous(),),
                 dict(compensated=False, src_quad=quad)),
        "mono_comp": (inputs[:2] + parts + (mask[:, U:].contiguous(),),
                      dict(compensated=True)),
    }
    out, modes = {}, {}
    for form, (args, kw) in segs.items():
        worst = 0.0
        for mode in ("both", "acc", "pot"):
            got = shared.eval_shared_fused(*args, LF_EPS, 1.0, mode=mode,
                                           **kw)
            want = shared.eval_shared_plain(*args, LF_EPS, 1.0, mode=mode,
                                            **kw)
            err = compare(got, want)
            worst = max(worst, err)
            km = cuda_ms(lambda: shared.eval_shared_fused(
                *args, LF_EPS, 1.0, mode=mode, **kw), 10)
            pm = cuda_ms(lambda: shared.eval_shared_plain(
                *args, LF_EPS, 1.0, mode=mode, **kw), 1)
            modes.setdefault(form, {})[mode] = {"ms": km, "plain_ms": pm,
                                                "max_abs_err": err}
        b_ms, b_by = bound(args + ((quad,) if "quad" in form else ()), n,
                           quad="quad" in form, comp="comp" in form)
        out[form] = dict(max_abs_err=worst, ms=modes[form]["both"]["ms"],
                         plain_ms=modes[form]["both"]["plain_ms"],
                         bound_ms=b_ms, bound_by=b_by)
    C, T, _ = inputs[0].shape
    emit("kernel", config="energy", chunk=0, C=C, T=T, U=U,
         S=int(inputs[2].shape[0]),
         active_blocks={"nodes": int(shared.active_blocks(
             mask[:, :U])[1].sum()), "particles": int(shared.active_blocks(
                 mask[:, U:].contiguous())[1].sum())},
         modes=modes, bounds={f: (v["bound_ms"], v["bound_by"])
                              for f, v in out.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    from rakau_tpu_torch import direct_acc_pot_np, octree, particles
    from rakau_tpu_torch import engine
    from rakau_tpu_torch.kernels import shared

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    lib_path = shared.build_library()
    build_s = time.perf_counter() - t0
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt").read_text()
    regs = [int(w) for w in re.findall(r"Used (\d+) registers", ptxas)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)]
    emit("build", seconds=build_s, library=lib_path.name,
         kernels=len(regs), registers=regs, spill_bytes=spills)
    if not regs or any(spills):
        raise AssertionError(f"ptxas: {len(regs)} kernels, spills {spills}")

    edge_err, cancel = edge_cases(shared, dev)
    emit("edge", max_abs_err=edge_err, cancellation_err=cancel)

    # ---- main path -----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pos, mass = particles.plummer(args.n, generator=gen)
    torch.cuda.synchronize()
    shared.reset_launches()
    t0 = time.perf_counter()
    tree = octree(coords=pos, masses=mass, **TREE_KW)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3

    def query():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = tree.accs_pots_o(THETA)
        stop.record()
        stop.synchronize()
        return out, start.elapsed_time(stop)

    _, cold_ms = query()
    cold_launches = shared.launches["mono"]     # build + cold query
    warm, per_query = [], []
    for _ in range(WARM_REPS):
        shared.reset_launches()
        (acc, pot), ms = query()
        per_query.append(shared.launches["mono"])
        if any(shared.launches[f] for f in ("mono_comp", "quad",
                                            "quad_comp")):
            raise AssertionError(f"main path launches {shared.launches}")
        warm.append(ms)
    launches = per_query[0]
    warm_ms = statistics.median(warm)
    td, cfg = tree.tree_data, tree.config
    chunks = engine.live_chunks(td, cfg)
    emit("main", n=args.n, theta=THETA, build_ms=build_ms,
         cold_query_ms=cold_ms, warm_query_ms=warm_ms, warm_query_ms_all=warm,
         warm_spread=(max(warm) - min(warm)) / warm_ms,
         n_nodes=tree.n_nodes, n_tiles=int(td.n_tiles), chunks=chunks,
         launches=launches, launches_per_warm_query=per_query,
         cold_launches=cold_launches,
         caps={f: getattr(cfg, f) for f in
               ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap", "frontier_cap")},
         evals_per_s=args.n / (warm_ms / 1e3))
    if any(k != chunks for k in per_query) or chunks <= 0:
        raise AssertionError(
            f"kernel launches per warm query {per_query} != chunks {chunks}")
    if acc.shape != (args.n, 3) or pot.shape != (args.n,):
        raise AssertionError(f"bad shapes {acc.shape} {pot.shape}")
    if not (torch.isfinite(acc).all() and torch.isfinite(pot).all()):
        raise AssertionError("non-finite accelerations or potentials")

    # ---- where a warm query's time goes ---------------------------------
    emit("layers", warm_query_ms=warm_ms, **layer_ms(tree))
    prof = device_profile(tree)
    emit("profile", **prof, warm_query_ms=warm_ms,
         idle_share=1 - prof["device_busy_ms"] / warm_ms,
         idle_share_profiled=1 - prof["device_busy_ms"]
         / prof["profiled_query_ms"])

    # ---- kernel vs plain at the main path's chunk shapes ----------------
    worst, k_ms, p_ms, b_ms, per_mode = 0.0, [], [], [], {}
    for ch in range(min(2, chunks)):
        inputs = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)[:6]
        for mode in ("both", "acc", "pot"):
            got = shared.eval_shared_fused(*inputs, 0.0, 1.0, mode=mode)
            want = shared.eval_shared_plain(*inputs, 0.0, 1.0, mode=mode)
            err = compare(got, want)
            worst = max(worst, err)
            km = cuda_ms(lambda: shared.eval_shared_fused(
                *inputs, 0.0, 1.0, mode=mode), 10)
            pm = cuda_ms(lambda: shared.eval_shared_plain(
                *inputs, 0.0, 1.0, mode=mode), 3)
            per_mode.setdefault(mode, []).append(
                {"chunk": ch, "ms": km, "plain_ms": pm, "max_abs_err": err})
            if mode == "both":
                k_ms.append(km)
                p_ms.append(pm)
        C, T, _ = inputs[0].shape
        b, b_by = bound(inputs, args.n)
        b_ms.append((b, b_by))
        emit("kernel", chunk=ch, C=C, T=T, S=int(inputs[2].shape[0]),
             active_blocks=int(shared.active_blocks(inputs[5])[1].sum()),
             modes={m: v[-1] for m, v in per_mode.items()},
             bound_ms=b, bound_by=b_by)

    # ---- accuracy against the float64 oracle ----------------------------
    samp = np.sort(np.random.default_rng(args.seed + 1).choice(
        args.n, 256, replace=False))
    pos_np = pos.double().cpu().numpy()
    acc_o, pot_o = direct_acc_pot_np(pos_np, mass.double().cpu().numpy(),
                                     targets=samp)
    a = acc[torch.as_tensor(samp, device=dev)].double().cpu().numpy()
    p = pot[torch.as_tensor(samp, device=dev)].double().cpu().numpy()
    f_rel = np.linalg.norm(a - acc_o, axis=1) / np.linalg.norm(acc_o, axis=1)
    p_rel = np.abs(p - pot_o) / np.abs(pot_o)
    f_rms = float(np.sqrt(np.mean(f_rel ** 2)))
    p_rms = float(np.sqrt(np.mean(p_rel ** 2)))
    emit("accuracy", samples=256, force_rms=f_rms, pot_rms=p_rms,
         force_max=float(f_rel.max()))
    if not f_rms < FORCE_RMS_MAX or not p_rms < POT_RMS_MAX:
        raise AssertionError(f"accuracy: force rms {f_rms:.3e}, "
                             f"pot rms {p_rms:.3e}")

    # ---- BASELINE config #2: the leapfrog harness -----------------------
    lf, etree, ecfg = leapfrog(args.n, args.seed + 2, dev)
    forms = energy_kernels(etree, ecfg)

    kernels = [{
        "name": "K1a shared_fused (monopole, fp32)", "route": "cuda",
        "source": SRC, "replaces": REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": float(np.mean(k_ms)),
        "plain_ms": float(np.mean(p_ms)),
        # the mean of the chunks' bounds, limited as the larger of them is
        "bound_ms": float(np.mean([b for b, _ in b_ms])),
        "bound_by": max(b_ms)[1], "library_ms": None}]
    for form, name, n_launch in (
            ("mono_comp", "K1b shared_fused (monopole, compensated)",
             lf["energy_launches"]["mono_comp"]),
            ("quad", "K1d shared_fused (quadrupole, fp32)",
             lf["fp32_quad_launches"]["quad"]),
            ("quad_comp", "K1d+K1b shared_fused (quadrupole, compensated)",
             lf["energy_launches"]["quad_comp"])):
        kernels.append({"name": name, "route": "cuda", "source": SRC,
                        "replaces": REPLACES, "launches": n_launch,
                        **forms[form], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
