#!/usr/bin/env python3
"""Drive the PyTorch port (rakau_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--n N] [--seed S]

Phases, each printing one JSON line:
  1. device:   the card (nvidia-smi name and power limit), torch and CUDA;
  2. build:    nvcc builds the pairwise kernel from csrc/ (timed);
  3. edge:     kernel vs plain PyTorch on small random cases (self pairs,
               far padding, an empty tile, ragged T and S, every mode);
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
               RMS relative force error < 5e-3, potential < 2e-3.
Then the kernels' summary line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure raises (non-zero exit) before
that line. Needs a CUDA card; JAX is not used.
"""
from __future__ import annotations

import argparse
import json
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
    """Kernel vs plain on small cases that hit every branch of the kernel."""
    rng = np.random.default_rng(7)
    worst = 0.0
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
        for mode in ("both", "acc", "pot"):
            got = shared.eval_shared_fused(*args, eps, 1.5, mode=mode)
            want = shared.eval_shared_plain(*args, eps, 1.5, mode=mode)
            worst = max(worst, compare(got, want))
            if C > 1 and bool(got[0][-1].any() | got[1][-1].any()):
                raise AssertionError("empty tile got a nonzero result")
    return worst


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
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    emit("build", seconds=build_s, library=lib_path.name,
         ptxas=ptxas.read_text().strip().splitlines()[-2:]
         if ptxas.exists() else None)

    emit("edge", max_abs_err=edge_cases(shared, dev))

    # ---- main path -----------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pos, mass = particles.plummer(args.n, generator=gen)
    torch.cuda.synchronize()
    shared.launches = 0
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
    cold_launches = shared.launches      # build + cold query
    warm, per_query = [], []
    for _ in range(WARM_REPS):
        shared.launches = 0
        (acc, pot), ms = query()
        per_query.append(shared.launches)
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
    worst, k_ms, p_ms, per_mode = 0.0, [], [], {}
    for ch in range(min(2, chunks)):
        inputs = engine.kernel_inputs(td, cfg, THETA, 0.0, ch)
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
        emit("kernel", chunk=ch, C=C, T=T, S=int(inputs[2].shape[0]),
             active_blocks=int(shared.active_blocks(inputs[5])[1].sum()),
             modes={m: v[-1] for m, v in per_mode.items()})

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

    print(json.dumps({"kernels": [{
        "name": "shared_fused", "route": "cuda",
        "source": "rakau_tpu_torch/csrc/shared_fused.cu",
        "replaces": "rakau_tpu/kernels/pallas.py:566",
        "launches": launches, "max_abs_err": worst,
        "ms": float(np.mean(k_ms)), "plain_ms": float(np.mean(p_ms))}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
