"""Time the hand-written kernels K1 (rakau_tpu_torch/csrc/shared_fused.cu),
K2 (csrc/pool.cu), K3 and K4 (csrc/tiles.cu), K5 (csrc/shared_blocks.cu)
and K6 (csrc/shared_mma.cu) of this checkout against those of another
checkout, on the same inputs on one CUDA card, and sweep this checkout's
build options and span lengths.

    python3 ab_kernels.py --other DIR [--kernels k1,k2,k3,k4,k5,k6]
        [--n 1048576] [--reps 20] [--out FILE] [--sweep G:TPT:UNROLL:MINB,...]
        [--spans SPAN,...] [--pool-spans SPAN,...] [--tiles-spans SPAN,...]
        [--rows-sweep TPT:UNROLL:MINB,...] [--mma-spans SPAN,...]
        [--mma-sweep WARPS:SLABS,...] [--blocks-spans SPAN,...]
        [--blocks-sweep STEP:TPT:UNROLL:THREADS,...]
        [--pairwise-spans SPAN,...]

DIR is the root of the other checkout (an unpacked `git archive` of an
earlier commit, say). Its csrc/<kernel>.cu is built with the flags of
kernels/shared.py:build_library into rakau_tpu_torch/_build/other/ (the
float64 build too where a form is float64) and called through ctypes with
the launch signature its source declares: K1 this side's (the granule
plan) or the row-at-a-time signature of the 1024-source block plan (with
or without the cell_dims argument), K2 and K3 this side's (the granule
plan) or the one-launch signatures of their earlier kernels (no G factor,
K3's block plan of min(1024, Sm, Sp)), K6 the signature of its
1024-source block plan (no G), K5 and K4 this side's or the static split
of the row (grid (C, T / 128, nsplit), nsplit from the split's own rule:
8 CUDA blocks an SM; K5 with its active blocks made here once).

K1's inputs are chunks 0 and 1 of a query of a seeded Plummer sphere of n
particles: the shared traversal, farfield "grid2" (order 4, grid_sep 3),
multipole_order 2, theta 0.75, eps 0. The node rows [0, U) with their
second moments go to the quadrupole forms, the particle rows [U, S) to the
monopole forms, the leaf cells to the cell forms, as the engine hands them
out. K2's are the pools of chip_smoke.py's gwalk queries of the same
particles (bench.py's gwalk+grid configuration: the monopole; the
quadrupole + compensated m2p configuration, pool window 131072: all four
forms) and of its F1 float64 gwalk query (65,536 particles, theta 0.4: the
monopole in float64). K3's are chunks 0 and 1 of the lists query of the
same particles (chip_smoke.py's LISTS_KW) and chunk 0 of F1's float64
lists query. K6's are chunks 0 and 1 of chip_smoke.py's shared+grid query
(its main path) and of its lmac+grid2 query (LMAC_KW, the cell form) of
the same particles, in each precision. K5's are the shared+grid chunks 0
and 1 and the dense row of metrics.measure_kernel_roof (its roof); K4's
are K3's (one chunk's two launches, one a row, and the add of their sums,
as eval_tiles(fused=False) runs them). Each form and input runs other,
this, this, other: `reps` launches each between two CUDA events (the card
held busy while the host enqueues them), the host work (the other's block
plan; this side's plan tensors and workspace) done once outside the
timing. This side's time is the whole launch (K1: the plan, the row
packing, the main kernel and the span reduction, and `this_kernel_ms` the
last two alone; K2 and K3: the one C call that runs their plan, packing,
kernel and reduction; K6: its plan's three kernels, the packing, the
kernel and its reduction), with the device time of each of its kernels
from one profiled launch (K2, K3, K6). The sums are not expected to be
bit-equal (another order of summation): the largest difference is
reported, beside whether two launches of this side agree bit for bit and
whether the plan its kernel builds equals the PyTorch plan (K6: also
whether they lie within chip_smoke.py's MMA_ATOL_REL of the other's
largest sum), and whether the two sides' sums are bit-equal (K2 and K3
against a parent on the same design: the MUFU rsqrt must keep them so).

--sweep builds K1's source again with -DRAKAU_GRANULE, -DRAKAU_TPT
(targets a thread), -DRAKAU_UNROLL and -DRAKAU_MIN_BLOCKS (the launch
bound's blocks a SM, 0 for none) for each G:TPT:UNROLL:MINB (trailing
fields may be left out: the source's defaults), and times every build at
every span length of --spans (list entries a work item), each beside the
default build (default, variant, variant, default). --pool-spans and
--tiles-spans time K2 and K3 at other span lengths (granules a work item)
beside their defaults; --rows-sweep builds K2's and K3's sources again
with -DRAKAU_TPT, -DRAKAU_UNROLL and -DRAKAU_MIN_BLOCKS (csrc/rows.cuh) for
each TPT:UNROLL:MINB and times each build beside the default one;
--mma-spans and --mma-sweep do the same for K6 (-DRAKAU_MMA_WARPS and
-DRAKAU_MMA_SLABS for each WARPS:SLABS), --blocks-spans and --blocks-sweep
for K5 (-DRAKAU_STEP, -DRAKAU_TPT, -DRAKAU_UNROLL and -DRAKAU_THREADS
for each STEP:TPT:UNROLL:THREADS) and --pairwise-spans for K4
(--rows-sweep builds K4's source too). Prints one JSON line per form and
input, the card's name and power limit, and a
summary line; with --out, writes them all to that file too.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

FORMS = ("mono", "mono_comp", "quad", "quad_comp", "mono_cell",
         "mono_comp_cell", "quad_cell", "quad_comp_cell")
KW = dict(max_depth=14, max_leaf_n=32, ncrit=512, tile_chunk=32,
          farfield="grid2", local_order=4, grid_sep=3, multipole_order=2,
          m2p_cap=9728, p2p_leaf_cap=5888, p2p_src_cap=47104,
          frontier_cap=1024)
THETA = 0.75


def compile_other(root: Path, name: str, f64: bool = False) -> Path:
    """root's csrc/<name>.cu built as kernels/shared.py builds this side's,
    into _build/other/."""
    from rakau_tpu_torch.kernels import shared
    src = root / "rakau_tpu_torch" / "csrc" / f"{name}.cu"
    out_dir = shared._BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"lib{name}_other{'_f64' if f64 else ''}.so"
    cmd = [shared._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(["-DRAKAU_REAL=double"] if f64 else []), "-o", str(out),
           str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out


def c_signature(root: Path, name: str, fn: str) -> str:
    """The declaration of extern "C" function `fn` in root's
    csrc/<name>.cu, up to its body, or "" where it has none."""
    text = (root / "rakau_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    at = text.find(f'extern "C" int {fn}(')
    return "" if at < 0 else text[at:text.index("{", at)]


def bind_some(path: Path, name: str, f64: bool = False):
    """The library at `path` (of csrc/<name>.cu, another checkout's) with
    the argument and result types of kernels/shared.py declared for the
    functions of this side's library that it has."""
    from rakau_tpu_torch.kernels import shared
    real = ctypes.c_double if f64 else ctypes.c_float
    lib = ctypes.CDLL(str(path))
    for fname, argtypes in shared._LIBRARIES[name][0].items():
        if not hasattr(lib, fname):
            continue
        fn = getattr(lib, fname)
        fn.restype = shared._RESTYPES.get(fname, ctypes.c_int)
        fn.argtypes = [real if a is shared._REAL else a for a in argtypes]
    return lib


def build_other(root: Path) -> tuple:
    """(loaded library, its plan) of root's shared_fused.cu: "granules"
    for a K1 on the granule plan (this side's C interface), else
    "blocks" or "blocks_dims" (the 1024-source block plan, without or with
    the cell_dims argument)."""
    from rakau_tpu_torch.kernels import shared
    src = root / "rakau_tpu_torch" / "csrc" / "shared_fused.cu"
    out = compile_other(root, "shared_fused")
    text = src.read_text()
    sig = text[text.index('extern "C" int rakau_shared_fused('):]
    sig = sig[:sig.index("{")]
    if "int span" in sig:
        return shared.bind_library(out), "granules"
    dims = "int cell_dims" in sig
    lib = ctypes.CDLL(str(out))
    fn = lib.rakau_shared_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * (8 if dims else 7)
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib, "blocks_dims" if dims else "blocks"


MACROS = ("RAKAU_GRANULE", "RAKAU_TPT", "RAKAU_UNROLL", "RAKAU_MIN_BLOCKS")


def build_this(variants) -> dict:
    """variant -> this checkout's library built with its macros (values of
    MACROS in order; None: the default build), all builds started
    together."""
    from rakau_tpu_torch.kernels import shared

    def one(v):
        if v is None:
            return v, shared._library("shared_fused")
        path = shared.build_library("shared_fused", macros=tuple(
            f"-D{m}={x}" for m, x in zip(MACROS, v)))
        return v, shared.bind_library(path)
    with ThreadPoolExecutor(len(variants)) as ex:
        return dict(ex.map(one, variants))


def form_args(inp, form: str) -> dict:
    """The rows, the options and the other's block plan of `form` on one
    chunk's kernel inputs (engine.kernel_inputs)."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask, quad, scell, tcell = inp
    U = quad.shape[0]
    rows = slice(0, U) if form.startswith("quad") else slice(U, None)
    m = mask[:, rows].contiguous()
    ids, cnt = shared.active_blocks(m)
    cell = form.endswith("_cell")
    return dict(
        tensors=(tpos, tidx, spos[rows].contiguous(),
                 smass[rows].contiguous(), sidx[rows].contiguous(), m),
        quad=quad if form.startswith("quad") else None,
        scell=scell[rows].to(torch.int32).contiguous() if cell else None,
        tcell=tcell.to(torch.int32).contiguous() if cell else None,
        comp="_comp" in form, ids=ids, cnt=cnt)


def other_launcher(fn, dims: bool, a: dict, sep: int):
    """A closure that launches the other's fn on `a` into its own
    outputs."""
    tpos = a["tensors"][0]
    C, T, D = tpos.shape
    S = a["tensors"][2].shape[0]
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=tpos.device)
    pot = torch.empty((C, T), dtype=torch.float32, device=tpos.device)
    ptr = [t.data_ptr() for t in a["tensors"]]
    opt = [None if t is None else t.data_ptr()
           for t in (a["quad"], a["scell"], a["tcell"])]
    cell_sep = sep if a["scell"] is not None else 0
    ints = [C, T, S, a["ids"].shape[1], 0, int(a["comp"]), cell_sep]
    if dims:
        ints.append(D)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(*ptr, *opt, a["ids"].data_ptr(), a["cnt"].data_ptr(),
                 acc.data_ptr(), pot.data_ptr(), *ints, 0.0, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return acc, pot
    return run


def this_launchers(lib, a: dict, sep: int, span: int):
    """(whole launch, launch with the plan and the row made outside, shape)
    of this side's `lib` on `a` at `span`: the workspace made here, outside
    the timing; the whole launch builds the plan (its two kernels), packs
    the row and runs the kernel and its reduction, the other only the last
    two, over a plan and a row made once here. The shape is the launch's
    granules, spans, work items, CUDA blocks and warps per SM, from
    shared.fused_plan at the library's granule."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask = a["tensors"]
    C, T, D = tpos.shape
    S = spos.shape[0]
    dev = tpos.device
    granule = lib.rakau_shared_fused_granule()
    quad, comp = a["quad"] is not None, int(a["comp"])
    tpt = lib.rakau_shared_fused_targets_per_thread()
    plan = shared.fused_plan(mask, span=span, granule=granule)
    cell = a["scell"] is not None
    cell_sep = sep if cell else 0
    ws = torch.empty(lib.rakau_shared_fused_workspace(
        C, T, S, span, int(quad), int(cell), comp), dtype=torch.uint8,
        device=dev)
    dplan = shared.FusedPlan(*(torch.empty_like(t) for t in plan[:4]),
                             plan.zmax)
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((C, T), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sms = shared.multiprocessors(dev)

    def prepare():
        err = lib.rakau_shared_fused_plan(
            mask.data_ptr(), ws.data_ptr(),
            *(t.data_ptr() for t in dplan[:4]), C, S, span, stream)
        err = err or lib.rakau_shared_fused_pack(
            spos.data_ptr(), smass.data_ptr(), sidx.data_ptr(),
            a["quad"].data_ptr() if quad else None,
            a["scell"].data_ptr() if cell else None, ws.data_ptr(), C, T,
            S, span, comp, D if cell else 0, stream)
        if err:
            raise RuntimeError(f"plan or pack failed: {err}")

    def kernel():
        err = lib.rakau_shared_fused(
            tpos.data_ptr(), tidx.data_ptr(),
            a["tcell"].data_ptr() if cell else None,
            *(t.data_ptr() for t in dplan[:4]), ws.data_ptr(),
            acc.data_ptr(), pot.data_ptr(),
            C, T, S, span, 0, comp, int(quad), cell_sep, D, sms, 0.0, 1.0,
            stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return acc, pot

    def whole():
        prepare()
        return kernel()

    prepare()
    grid = lib.rakau_shared_fused_grid(C, T, S, span, 0, comp, int(quad),
                                       cell_sep, D, sms)
    per_sm = lib.rakau_shared_fused_blocks_per_sm(0, comp, int(quad),
                                                  cell_sep, D)
    items = int(plan.n_work[0]) * -(-T // (128 * tpt))
    shape = dict(granule=granule, targets_per_thread=tpt, span=span,
                 granules=int(plan.cnt.sum()), spans=int(plan.n_work[0]),
                 items=items, cuda_blocks=grid, blocks_per_sm_fit=per_sm,
                 warps_per_sm=4 * min(grid, items) / sms,
                 device_plan_equal=all(torch.equal(x, y) for x, y in
                                       zip(dplan[:4], plan[:4])))
    return whole, kernel, shape


def event_ms(run, reps: int) -> float:
    """Mean device time of run() over reps calls, the card spinning ~10 ms
    first while the host enqueues them (so that the host's launch rate is
    not what is timed)."""
    run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def max_diff(x, y) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(x, y))


def profile_kernels(run, calls: int = 5) -> dict:
    """Device ms of each kernel of a call of run(), by kernel name (the
    kernel's own name, without its namespace and arguments): the mean over
    the launches of that name the profiler kept from `calls` calls (each
    call launches each of its kernels once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    spans: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("<")[0].split("(")[0].split()[-1].split("::")[-1]
        spans.setdefault(name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    return {k: sum(v) / len(v) for k, v in spans.items()}


def turns(run_a, run_b, reps: int) -> list:
    """[a, b, b, a] mean device ms of each over reps calls."""
    return [event_ms(r, reps) for r in (run_a, run_b, run_b, run_a)]


def ab_k1(args, dev, card) -> tuple:
    """K1's float32 forms on the grid2 chunks 0, 1 against the other
    checkout's, and the sweep. Returns (lines, summary)."""
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.kernels import shared
    sweep = [tuple(int(x) for x in v.split(":"))
             for v in args.sweep.split(",") if v]
    spans = [int(x) for x in args.spans.split(",") if x] or [shared.SPAN]
    with ThreadPoolExecutor(2) as ex:
        other_f = ex.submit(build_other, args.other.resolve())
        libs = build_this([None] + sweep)
        other_lib, other_plan = other_f.result()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pos, mass = particles.plummer(args.n, generator=gen)
    cfg = TreeConfig(**KW)
    tree = Tree(coords=pos, masses=mass, config=cfg)
    tree.accs_pots_o(THETA)         # grows what overflows
    td, cfg = tree.tree_data, tree.config
    lines, ratios = [], {}
    for chunk in (0, 1):
        inp = engine.kernel_inputs(td, cfg, THETA, 0.0, chunk)
        for form in FORMS:
            a = form_args(inp, form)
            if other_plan == "granules":
                run_o = this_launchers(other_lib, a, cfg.grid_sep,
                                       shared.SPAN)[0]
            else:
                run_o = other_launcher(other_lib.rakau_shared_fused,
                                       other_plan == "blocks_dims", a,
                                       cfg.grid_sep)
            run_t, kern_t, shape = this_launchers(libs[None], a,
                                                  cfg.grid_sep, shared.SPAN)
            got_o = [t.clone() for t in run_o()]
            got_t = [t.clone() for t in run_t()]
            again = run_t()
            ms = turns(run_o, run_t, args.reps)
            kms = event_ms(kern_t, args.reps)
            scale = max(float(t.abs().max()) for t in got_o)
            C, T, _ = a["tensors"][0].shape
            pairs = shape["granules"] * shape["granule"] * T
            rec = dict(kernel="K1", form=form, chunk=chunk,
                       other_active_blocks=(None if other_plan == "granules"
                                            else int(a["cnt"].sum())),
                       other_ms=[ms[0], ms[3]], this_ms=[ms[1], ms[2]],
                       this_kernel_ms=kms,
                       ratio=(ms[1] + ms[2]) / (ms[0] + ms[3]),
                       max_abs_diff=max_diff(got_o, got_t),
                       max_rel_diff=max_diff(got_o, got_t) / scale,
                       repeat_bit_equal=all(torch.equal(x, y) for x, y
                                            in zip(got_t, again)),
                       processed_gpairs_per_s=pairs / (ms[1] * 1e6),
                       **shape)
            sw = {}
            for v in sweep:
                for span in spans:
                    run_v, _, vshape = this_launchers(libs[v], a,
                                                      cfg.grid_sep, span)
                    got_v = run_v()
                    t = turns(run_t, run_v, args.reps)
                    sw[":".join(map(str, v)) + f"/span{span}"] = dict(
                        ms=(t[1] + t[2]) / 2, default_ms=(t[0] + t[3]) / 2,
                        over_default=(t[1] + t[2]) / (t[0] + t[3]),
                        max_rel_diff=max_diff(got_o, got_v) / scale,
                        granules=vshape["granules"], spans=vshape["spans"],
                        cuda_blocks=vshape["cuda_blocks"],
                        warps_per_sm=vshape["warps_per_sm"])
            if sw:
                rec["sweep"] = sw
            ratios.setdefault(form, []).append(rec["ratio"])
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    del tree
    torch.cuda.empty_cache()
    return lines, dict(other_k1_plan=other_plan,
                       granule=shared.GRANULE, span=shared.SPAN,
                       ratio_this_over_other=ratios)


def _real(f64: bool):
    return ctypes.c_double if f64 else ctypes.c_float


def other_pool(lib, inputs, window: int, block: int, form: str):
    """The other checkout's K2 (one launch, no G) on a pool, into its own
    outputs."""
    tpos, tidx, ppos, pmass, pidx, sched, pquad = inputs
    G, T, _ = tpos.shape
    quad, comp = form.startswith("quad"), form.endswith("comp")
    fn = lib.rakau_pool
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [_real(tpos.dtype == torch.float64), ctypes.c_void_p])
    acc = torch.empty((G, T, 3), dtype=tpos.dtype, device=tpos.device)
    pot = torch.empty((G, T), dtype=tpos.dtype, device=tpos.device)
    s32 = sched.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tpos.data_ptr(), tidx.data_ptr(), ppos.data_ptr(),
                 pmass.data_ptr(), pidx.data_ptr(),
                 pquad.data_ptr() if quad else None, s32.data_ptr(),
                 acc.data_ptr(), pot.data_ptr(), G, T, window // block,
                 block, 0, int(comp), 0.0, stream)
        if err:
            raise RuntimeError(f"other K2 launch failed: {err}")
        return acc, pot
    return run


def this_pool(lib, inputs, window: int, block: int, form: str, span: int):
    """This side's K2 (its whole launch, one C call) on a pool at `span`,
    the plan tensors and the workspace made here; and the plan its kernel
    builds against pool_plan's."""
    from rakau_tpu_torch.kernels import pool, rows, shared
    tpos, tidx, ppos, pmass, pidx, sched, pquad = inputs
    G, T, _ = tpos.shape
    P = ppos.shape[0]
    quad, comp = form.startswith("quad"), form.endswith("comp")
    dev = tpos.device
    cap = pool.span_capacity(G, P, window, block, span)
    plan = rows.plan_views(torch.empty(G + cap + 2, dtype=torch.int32,
                                       device=dev), G, cap)
    ws = torch.empty(lib.rakau_pool_workspace(T, cap, int(comp)),
                     dtype=torch.uint8, device=dev)
    acc = torch.empty((G, T, 3), dtype=tpos.dtype, device=dev)
    pot = torch.empty((G, T), dtype=tpos.dtype, device=dev)
    s32 = sched.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    sms = shared.multiprocessors(dev)

    def run():
        err = lib.rakau_pool(
            tpos.data_ptr(), tidx.data_ptr(), ppos.data_ptr(),
            pmass.data_ptr(), pidx.data_ptr(),
            pquad.data_ptr() if quad else None, s32.data_ptr(),
            *(t.data_ptr() for t in plan), ws.data_ptr(), acc.data_ptr(),
            pot.data_ptr(), G, T, P, window // block, block, span, cap, 0,
            int(comp), sms, 0.0, 1.0, stream)
        if err:
            raise RuntimeError(f"K2 launch failed: {err}")
        return acc, pot
    run()
    want = pool.pool_plan(sched, window, block, P, span)
    same = all(torch.equal(x, y) for x, y in zip(plan, want))
    items = int(want.n_work[0]) * -(-T // (
        128 * lib.rakau_pool_targets_per_thread()))
    grid = lib.rakau_pool_grid(cap, T, 0, int(comp), int(quad), sms)
    return run, dict(span=span, spans=int(want.n_work[0]), work_items=items,
                     cuda_blocks=grid, warps_per_sm=4 * min(grid, items)
                     / sms, device_plan_equal=same)


def other_tiles(lib, a):
    """The other checkout's K3 (one launch, no G, the block plan of
    min(1024, Sm, Sp)) on one chunk's rows, into its own outputs."""
    tp, ti, mp, mm, mc, pp, pm, pi, pc = a
    C, T, _ = tp.shape
    Sm, Sp = mp.shape[1], pp.shape[1]
    fn = lib.rakau_tiles
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [_real(tp.dtype == torch.float64), ctypes.c_void_p])
    acc = torch.empty((C, T, 3), dtype=tp.dtype, device=tp.device)
    pot = torch.empty((C, T), dtype=tp.dtype, device=tp.device)
    mc64, pc64 = mc.to(torch.int64), pc.to(torch.int64)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tp.data_ptr(), ti.data_ptr(), mp.data_ptr(), mm.data_ptr(),
                 mc64.data_ptr(), pp.data_ptr(), pm.data_ptr(),
                 pi.data_ptr(), pc64.data_ptr(), acc.data_ptr(),
                 pot.data_ptr(), C, T, Sm, Sp, max(1, min(1024, Sm, Sp)),
                 0.0, stream)
        if err:
            raise RuntimeError(f"other K3 launch failed: {err}")
        return acc, pot
    return run


def this_tiles(lib, a, span: int):
    """This side's K3 (its whole launch, one C call) on one chunk's rows
    at `span`; and the plan its kernel builds against tiles_plan's."""
    from rakau_tpu_torch.kernels import rows, shared, tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = a
    C, T, _ = tp.shape
    Sm, Sp = mp.shape[1], pp.shape[1]
    dev = tp.device
    cap = tiles.tiles_capacity(C, Sm, Sp, span)
    plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                       device=dev), C, cap)
    ws = torch.empty(lib.rakau_tiles_workspace(T, cap), dtype=torch.uint8,
                     device=dev)
    acc = torch.empty((C, T, 3), dtype=tp.dtype, device=dev)
    pot = torch.empty((C, T), dtype=tp.dtype, device=dev)
    mc64, pc64 = mc.to(torch.int64), pc.to(torch.int64)
    stream = torch.cuda.current_stream().cuda_stream
    sms = shared.multiprocessors(dev)

    def run():
        err = lib.rakau_tiles(
            tp.data_ptr(), ti.data_ptr(), mp.data_ptr(), mm.data_ptr(),
            mc64.data_ptr(), pp.data_ptr(), pm.data_ptr(), pi.data_ptr(),
            pc64.data_ptr(), *(t.data_ptr() for t in plan), ws.data_ptr(),
            acc.data_ptr(), pot.data_ptr(), C, T, Sm, Sp, span, cap, sms,
            0.0, 1.0, stream)
        if err:
            raise RuntimeError(f"K3 launch failed: {err}")
        return acc, pot
    run()
    want = tiles.tiles_plan(C, Sm, Sp, mc, pc, span)
    same = all(torch.equal(x, y) for x, y in zip(plan, want))
    items = int(want.n_work[0]) * -(-T // (
        128 * lib.rakau_tiles_targets_per_thread()))
    grid = lib.rakau_tiles_grid(cap, T, sms)
    return run, dict(span=span, spans=int(want.n_work[0]), work_items=items,
                     cuda_blocks=grid, warps_per_sm=4 * min(grid, items)
                     / sms, device_plan_equal=same)


ROWS_MACROS = ("RAKAU_TPT", "RAKAU_UNROLL", "RAKAU_MIN_BLOCKS")


def rows_builds(name: str, sweep: str) -> dict:
    """label -> csrc/<name>.cu's float build with the macros of each
    TPT:UNROLL:MINB of `sweep`, built together."""
    from rakau_tpu_torch.kernels import shared
    vs = [v for v in sweep.split(",") if v]

    def one(v):
        path = shared.build_library(name, macros=tuple(
            f"-D{m}={x}" for m, x in zip(ROWS_MACROS, v.split(":"))))
        return f"build{v}", shared.bind_library(path, name)
    with ThreadPoolExecutor(max(1, len(vs))) as ex:
        return dict(ex.map(one, vs))


def compare_ab(key: dict, run_o, run_t, reps: int, variants=()) -> dict:
    """One A/B record: other, this, this, other; this side's repeat
    bit-equality, its kernels' device ms, the largest difference of the
    sums; each (label, run) of `variants` timed beside this side (this,
    variant, variant, this)."""
    got_o = [t.clone() for t in run_o()]
    got_t = [t.clone() for t in run_t()]
    again = run_t()
    ms = turns(run_o, run_t, reps)
    scale = max(float(t.abs().max()) for t in got_o)
    rec = dict(key, other_ms=[ms[0], ms[3]], this_ms=[ms[1], ms[2]],
               ratio=(ms[1] + ms[2]) / (ms[0] + ms[3]),
               max_abs_diff=max_diff(got_o, got_t),
               max_rel_diff=max_diff(got_o, got_t) / scale,
               bit_equal_to_other=all(torch.equal(x, y) for x, y in
                                      zip(got_o, got_t)),
               repeat_bit_equal=all(torch.equal(x, y) for x, y in
                                    zip(got_t, again)),
               this_kernels_device_ms=profile_kernels(run_t))
    for label, run_v in variants:
        got_v = [t.clone() for t in run_v()]
        t = turns(run_t, run_v, reps)
        rec.setdefault("variants", {})[label] = dict(
            ms=(t[1] + t[2]) / 2, default_ms=(t[0] + t[3]) / 2,
            over_default=(t[1] + t[2]) / (t[0] + t[3]),
            max_rel_diff=max_diff(got_o, got_v) / scale)
    return rec


def gwalk_pools(n: int, seed: int, dev):
    """(label, pool inputs, window, block, forms) of the pools K2 is timed
    on: chip_smoke.py's gwalk+grid and quadrupole + compensated m2p
    queries of n particles, and its F1 float64 gwalk query."""
    import chip_smoke as cs
    from rakau_tpu_torch import engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    mono = TreeConfig(farfield="m2p", **cs.gwalk_kw(n))
    for label, cfg, forms, theta in (
            ("gwalk+grid", TreeConfig(farfield="grid", **cs.gwalk_kw(n)),
             ("mono",), cs.THETA),
            ("gwalk+m2p quadrupole compensated", mono.with_(
                multipole_order=2, accum="compensated",
                pool_window=cs.QUAD_POOL_WINDOW), POOL_FORMS, cs.THETA)):
        tree, _ = cs.gwalk_tree(pos, mass, cfg, theta)
        inputs = engine.pool_inputs(tree.tree_data, tree.config, theta, 0.0)
        yield label, inputs, tree.config.pool_window, \
            tree.config.pool_block, forms
        del tree, inputs
        torch.cuda.empty_cache()
    del pos, mass
    p64, m64 = particles.plummer(cs.F1_N, generator=gen,
                                 dtype=torch.float64)
    cfg = TreeConfig(farfield="m2p", dtype="float64", **cs.gwalk_kw(cs.F1_N))
    tree, _ = cs.gwalk_tree(p64.cpu().numpy(), m64.cpu().numpy(), cfg,
                            cs.F1_F64_THETA)
    inputs = engine.pool_inputs(tree.tree_data, tree.config,
                                cs.F1_F64_THETA, 0.0)
    yield "gwalk_f64", inputs, tree.config.pool_window, \
        tree.config.pool_block, ("mono",)


POOL_FORMS = ("mono", "mono_comp", "quad", "quad_comp")


def ab_k2(args, dev, card) -> tuple:
    """K2's forms on the gwalk pools against the other checkout's, at
    other spans and in other builds. Returns (lines, summary)."""
    from rakau_tpu_torch.kernels import pool, shared
    spans = [int(x) for x in args.pool_spans.split(",") if x]
    root = args.other.resolve()
    granular = "int span" in c_signature(root, "pool", "rakau_pool")
    with ThreadPoolExecutor(2) as ex:
        others = {f64: ex.submit(compile_other, root, "pool", f64)
                  for f64 in (False, True)}
        this = {f64: shared._library("pool", f64) for f64 in (False, True)}
        others = {f64: bind_some(f.result(), "pool", f64)
                  for f64, f in others.items()}
    builds = rows_builds("pool", args.rows_sweep)
    lines, ratios = [], {}
    for label, inputs, window, block, forms in gwalk_pools(args.n, args.seed,
                                                           dev):
        f64 = inputs[0].dtype == torch.float64
        for form in forms:
            span = pool.form_span(form.startswith("quad"))
            run_o = (this_pool(others[f64], inputs, window, block, form,
                               span)[0] if granular else
                     other_pool(others[f64], inputs, window, block, form))
            run_t, shape = this_pool(this[f64], inputs, window, block, form,
                                     span)
            variants = [(f"span{sp}", this_pool(this[f64], inputs, window,
                                                block, form, sp)[0])
                        for sp in spans if sp != span and not f64]
            if not f64:
                variants += [(label_v, this_pool(lib_v, inputs, window,
                                                 block, form, span)[0])
                             for label_v, lib_v in builds.items()]
            rec = compare_ab(dict(kernel="K2", config=label, form=form,
                                  dtype="float64" if f64 else "float32",
                                  G=int(inputs[0].shape[0]),
                                  T=int(inputs[0].shape[1]),
                                  P=int(inputs[2].shape[0]), block=block,
                                  **shape),
                             run_o, run_t, args.reps, variants)
            ratios.setdefault(f"{label}/{form}", rec["ratio"])
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        del inputs
        torch.cuda.empty_cache()
    return lines, dict(pool_span=pool.SPAN, pool_quad_span=pool.QUAD_SPAN,
                       other_k2_granular=granular,
                       k2_ratio_this_over_other=ratios)


def lists_chunks(n: int, seed: int, dev):
    """(label, chunk, K3 arguments) of chip_smoke.py's lists query of n
    particles (chunks 0 and 1) and of its F1 float64 lists query (chunk
    0)."""
    import chip_smoke as cs
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    p64, m64 = particles.plummer(cs.F1_N, generator=gen, dtype=torch.float64)
    with cs.diag_modes():
        for label, tree, chunks, theta in (
                ("lists", Tree(coords=pos, masses=mass,
                               config=TreeConfig(**cs.LISTS_KW)), (0, 1),
                 cs.THETA),
                ("lists_f64", Tree(coords=p64.cpu().numpy(),
                                   masses=m64.cpu().numpy(),
                                   config=TreeConfig(dtype="float64",
                                                     **cs.LISTS_KW)), (0,),
                 cs.F1_F64_THETA)):
            tree.accs_pots_o(theta)     # grows what overflows
            for ch in chunks:
                inp = engine.tile_kernel_inputs(tree.tree_data, tree.config,
                                                theta, 0.0, ch)
                yield label, ch, (inp[0], inp[1], inp[2], inp[3], inp[8],
                                  inp[5], inp[6], inp[7], inp[9])
            del tree
            torch.cuda.empty_cache()


def tiles_libraries(root: Path) -> tuple:
    """(other, this): root's csrc/tiles.cu and this side's, each in its
    float32 and float64 builds ({f64: library}), built together."""
    from rakau_tpu_torch.kernels import shared
    with ThreadPoolExecutor(2) as ex:
        others = {f64: ex.submit(compile_other, root, "tiles", f64)
                  for f64 in (False, True)}
        this = {f64: shared._library("tiles", f64) for f64 in (False, True)}
        others = {f64: bind_some(f.result(), "tiles", f64)
                  for f64, f in others.items()}
    return others, this


def ab_k3(args, dev, card) -> tuple:
    """K3 on the lists chunks against the other checkout's, at other
    spans. Returns (lines, summary)."""
    from rakau_tpu_torch.kernels import shared, tiles
    spans = [int(x) for x in args.tiles_spans.split(",") if x]
    root = args.other.resolve()
    granular = "int span" in c_signature(root, "tiles", "rakau_tiles")
    others, this = tiles_libraries(root)
    builds = rows_builds("tiles", args.rows_sweep)
    lines, ratios = [], {}
    for label, ch, a in lists_chunks(args.n, args.seed, dev):
        f64 = a[0].dtype == torch.float64
        run_o = (this_tiles(others[f64], a, tiles.SPAN)[0] if granular
                 else other_tiles(others[f64], a))
        run_t, shape = this_tiles(this[f64], a, tiles.SPAN)
        variants = [(f"span{sp}", this_tiles(this[f64], a, sp)[0])
                    for sp in spans if sp != tiles.SPAN and not f64]
        if not f64:
            variants += [(label_v, this_tiles(lib_v, a, tiles.SPAN)[0])
                         for label_v, lib_v in builds.items()]
        rec = compare_ab(dict(kernel="K3", config=label, chunk=ch,
                              dtype="float64" if f64 else "float32",
                              C=int(a[0].shape[0]), T=int(a[0].shape[1]),
                              Sm=int(a[2].shape[1]), Sp=int(a[5].shape[1]),
                              **shape),
                         run_o, run_t, args.reps, variants)
        ratios.setdefault(label, []).append(rec["ratio"])
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    return lines, dict(tiles_span=tiles.SPAN, other_k3_granular=granular,
                       k3_ratio_this_over_other=ratios)


def mma_rows(n: int, seed: int, dev):
    """(label, chunk, the row's six tensors, cells or None) of K6's rows:
    chunks 0 and 1 of chip_smoke.py's shared+grid query (its main path's
    configuration) and of its lmac+grid2 query (LMAC_KW, caps grown and
    fitted as there), of a seeded Plummer sphere of n particles."""
    import chip_smoke as cs
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    for label, kw in (("shared+grid", cs.TREE_KW), ("lmac+grid2", cs.LMAC_KW)):
        tree = Tree(coords=pos, masses=mass, config=TreeConfig(**kw))
        tree.accs_pots_o(cs.THETA)      # grows what overflows
        if kw is cs.LMAC_KW:
            tree.tune_caps()
        td, cfg = tree.tree_data, tree.config
        for ch in (0, 1):
            inp = engine.kernel_inputs(td, cfg, cs.THETA, 0.0, ch)
            cells = None
            if inp[7] is not None:
                cells = (inp[7].to(torch.int32).contiguous(),
                         inp[8].to(torch.int32).contiguous(), cfg.grid_sep)
            yield label, ch, tuple(inp[:6]), cells
        del tree, td
        torch.cuda.empty_cache()


def other_mma(lib, args, cells, prec: str):
    """The other checkout's K6 (the 1024-source block plan: its C
    signature before K1's plan, no G) on one row, the block lists made
    here once, into its own outputs."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask = args
    C, T, D = tpos.shape
    S = spos.shape[0]
    fn = lib.rakau_shared_mma
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.rakau_shared_mma_block.restype = ctypes.c_int
    ids, cnt = shared.active_blocks(mask, lib.rakau_shared_mma_block())
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=tpos.device)
    pot = torch.empty((C, T), dtype=torch.float32, device=tpos.device)
    sep = cells[2] if cells else 0
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tpos.data_ptr(), spos.data_ptr(), smass.data_ptr(),
                 mask.data_ptr(), cells[0].data_ptr() if cells else None,
                 cells[1].data_ptr() if cells else None, ids.data_ptr(),
                 cnt.data_ptr(), acc.data_ptr(), pot.data_ptr(), C, T, S,
                 ids.shape[1], 0, shared.PRECS[prec], sep, D, 0.0, stream)
        if err:
            raise RuntimeError(f"other K6 launch failed: {err}")
        return acc, pot
    return run


def this_mma(lib, args, cells, prec: str, span: int):
    """This side's K6 (its whole launch: the plan's three kernels, the
    packing, the kernel and its reduction) on one row at `span`, the plan
    tensors and the workspace made here; and its launch shape, with the
    plan its kernels build against fused_plan's."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask = args
    C, T, D = tpos.shape
    S = spos.shape[0]
    dev = tpos.device
    plan = shared.fused_plan(mask, span=span)
    dplan = shared.FusedPlan(*(torch.empty_like(t) for t in plan[:4]),
                             plan.zmax)
    ws = torch.empty(lib.rakau_shared_mma_workspace(C, T, S, span,
                                                    int(cells is not None)),
                     dtype=torch.uint8, device=dev)
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((C, T), dtype=torch.float32, device=dev)
    sep = cells[2] if cells else 0
    pr = shared.PRECS[prec]
    sms = shared.multiprocessors(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.rakau_shared_mma_plan(
            mask.data_ptr(), ws.data_ptr(),
            *(t.data_ptr() for t in dplan[:4]), C, S, span, stream)
        err = err or lib.rakau_shared_mma_pack(
            spos.data_ptr(), smass.data_ptr(),
            cells[0].data_ptr() if cells else None, ws.data_ptr(), C, T, S,
            span, D if cells else 0, stream)
        err = err or lib.rakau_shared_mma(
            tpos.data_ptr(), cells[1].data_ptr() if cells else None,
            *(t.data_ptr() for t in dplan[:4]), ws.data_ptr(),
            acc.data_ptr(), pot.data_ptr(), C, T, S, span, 0, pr, sep, D,
            sms, 0.0, 1.0, stream)
        if err:
            raise RuntimeError(f"K6 launch failed: {err}")
        return acc, pot
    run()
    grid = lib.rakau_shared_mma_grid(C, T, S, span, 0, pr, sep, D, sms)
    tpi = lib.rakau_shared_mma_targets_per_item()
    items = int(plan.n_work[0]) * -(-T // tpi)
    return run, dict(
        span=span, granules=int(plan.cnt.sum()), spans=int(plan.n_work[0]),
        work_items=items, cuda_blocks=grid,
        blocks_per_sm_fit=lib.rakau_shared_mma_blocks_per_sm(0, pr, sep, D),
        warps_per_sm=lib.rakau_shared_mma_threads() // 32 * min(grid, items)
        / sms, device_plan_equal=all(torch.equal(x, y) for x, y in
                                     zip(dplan[:4], plan[:4])))


MMA_MACROS = ("RAKAU_MMA_WARPS", "RAKAU_MMA_SLABS")


def mma_builds(sweep: str) -> dict:
    """label -> csrc/shared_mma.cu built with the macros of each
    WARPS:SLABS of `sweep` (a trailing field may be left out: the
    source's default), built together."""
    from rakau_tpu_torch.kernels import shared
    vs = [v for v in sweep.split(",") if v]

    def one(v):
        path = shared.build_library("shared_mma", macros=tuple(
            f"-D{m}={x}" for m, x in zip(MMA_MACROS, v.split(":"))))
        return f"build{v}", shared.bind_library(path, "shared_mma")
    with ThreadPoolExecutor(max(1, len(vs))) as ex:
        return dict(ex.map(one, vs))


def ab_k6(args, dev, card) -> tuple:
    """K6 in every precision, with and without cells, on the shared+grid
    and lmac+grid2 chunks against the other checkout's, at other spans
    and in other builds. Returns (lines, summary)."""
    import chip_smoke as cs
    from rakau_tpu_torch.kernels import shared
    spans = [int(x) for x in args.mma_spans.split(",") if x]
    with ThreadPoolExecutor(2) as ex:
        other_f = ex.submit(compile_other, args.other.resolve(), "shared_mma")
        this = shared._library("shared_mma")
        other = ctypes.CDLL(str(other_f.result()))
    builds = mma_builds(args.mma_sweep)
    lines, ratios = [], {}
    for label, ch, row, cells in mma_rows(args.n, args.seed, dev):
        for prec in cs.PRECS:
            run_o = other_mma(other, row, cells, prec)
            run_t, shape = this_mma(this, row, cells, prec, shared.SPAN)
            variants = [(f"span{sp}", this_mma(this, row, cells, prec,
                                               sp)[0])
                        for sp in spans if sp != shared.SPAN]
            variants += [(lv, this_mma(lib_v, row, cells, prec,
                                       shared.SPAN)[0])
                         for lv, lib_v in builds.items()]
            form = ("mma_cell/" if cells else "mma/") + prec
            rec = compare_ab(dict(kernel="K6", config=label, chunk=ch,
                                  form=form, C=int(row[0].shape[0]),
                                  T=int(row[0].shape[1]),
                                  S=int(row[2].shape[0]), **shape),
                             run_o, run_t, args.reps, variants)
            rec["within_mma_atol_rel"] = rec["max_rel_diff"] \
                <= cs.MMA_ATOL_REL
            ratios.setdefault(f"{label}/{form}", []).append(rec["ratio"])
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    return lines, dict(mma_span=shared.SPAN, granule=shared.GRANULE,
                       k6_ratio_this_over_other=ratios)


# ---------------------------------------------------------------- K5, K4
def split_nsplit(C: int, T: int, nb: int, sms: int) -> int:
    """The static split's spans for a row of nb blocks (the rule of the
    kernels K5 and K4 had before their plans: as many as bring the launch
    to 8 CUDA blocks an SM, between 1 and one a block)."""
    base = C * -(-T // 128)
    return max(1, min(nb, -(-8 * sms // base)))


def shared_rows(n: int, seed: int, dev):
    """(label, chunk, the row's six tensors) of K5's rows: chunks 0 and 1
    of chip_smoke.py's shared+grid query of a seeded Plummer sphere of n
    particles, then the dense row of metrics.measure_kernel_roof at
    chip_smoke.py's ROOF_SOURCES (every pair live: the roof)."""
    import chip_smoke as cs
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos, mass = particles.plummer(n, generator=gen)
    tree = Tree(coords=pos, masses=mass, config=TreeConfig(**cs.TREE_KW))
    tree.accs_pots_o(cs.THETA)      # grows what overflows
    td, cfg = tree.tree_data, tree.config
    for ch in (0, 1):
        yield "shared+grid", ch, tuple(engine.kernel_inputs(
            td, cfg, cs.THETA, 0.0, ch)[:6])
    del tree, td
    torch.cuda.empty_cache()
    C, T, S = cfg.tile_chunk, cfg.ncrit, cs.ROOF_SOURCES
    tgt = (torch.arange(C * T * 3, dtype=torch.float32, device=dev)
           .reshape(C, T, 3) % 251.0) * 1e-3 + 1.0
    src = (torch.arange(S * 3, dtype=torch.float32, device=dev)
           .reshape(S, 3) % 257.0) * 1e-3 - 1.0
    yield "dense", 0, (tgt, torch.arange(C * T, device=dev).reshape(C, T),
                       src, torch.ones(S, device=dev),
                       torch.full((S,), -1, dtype=torch.int64, device=dev),
                       torch.ones((C, S), dtype=torch.bool, device=dev))


def other_blocks(lib, row):
    """The other checkout's K5 as the static split of the row (no G), its
    active blocks made here once, into its own outputs."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask = row
    C, T, _ = tpos.shape
    S = spos.shape[0]
    fn = lib.rakau_shared_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    blk = shared.block_any(mask).to(torch.uint8).contiguous()
    nb = blk.shape[1]
    nsplit = split_nsplit(C, T, nb, shared.multiprocessors(tpos.device))
    scratch = torch.empty((nsplit, C, T, 4), dtype=torch.float32,
                          device=tpos.device)
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=tpos.device)
    pot = torch.empty((C, T), dtype=torch.float32, device=tpos.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(tpos.data_ptr(), tidx.data_ptr(), spos.data_ptr(),
                 smass.data_ptr(), sidx.data_ptr(), mask.data_ptr(),
                 blk.data_ptr(), scratch.data_ptr(), acc.data_ptr(),
                 pot.data_ptr(), C, T, S, nb, nsplit, 0.0, stream)
        if err:
            raise RuntimeError(f"other K5 launch failed: {err}")
        return acc, pot
    return run


def this_blocks(lib, row, span: int):
    """This side's K5 (its whole launch: the plan's three kernels, the
    packing, the kernel and its reduction) on one row at `span`, the plan
    tensors and the workspace made here; and its launch shape, with the
    plan its kernels build against fused_plan's."""
    from rakau_tpu_torch.kernels import shared
    tpos, tidx, spos, smass, sidx, mask = row
    C, T, _ = tpos.shape
    S = spos.shape[0]
    dev = tpos.device
    plan = shared.fused_plan(mask, span, shared.BLOCK)
    dplan = shared.FusedPlan(*(torch.empty_like(t) for t in plan[:4]),
                             plan.zmax)
    ws = torch.empty(lib.rakau_shared_blocks_workspace(C, T, S, span),
                     dtype=torch.uint8, device=dev)
    acc = torch.empty((C, T, 3), dtype=torch.float32, device=dev)
    pot = torch.empty((C, T), dtype=torch.float32, device=dev)
    sms = shared.multiprocessors(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.rakau_shared_blocks_plan(
            mask.data_ptr(), ws.data_ptr(),
            *(t.data_ptr() for t in dplan[:4]), C, S, span, stream)
        err = err or lib.rakau_shared_blocks_pack(
            spos.data_ptr(), smass.data_ptr(), sidx.data_ptr(),
            ws.data_ptr(), C, T, S, span, stream)
        err = err or lib.rakau_shared_blocks(
            tpos.data_ptr(), tidx.data_ptr(),
            *(t.data_ptr() for t in dplan[:4]), ws.data_ptr(),
            acc.data_ptr(), pot.data_ptr(), C, T, S, span, sms, 0.0, 1.0,
            stream)
        if err:
            raise RuntimeError(f"K5 launch failed: {err}")
        return acc, pot
    run()
    grid = lib.rakau_shared_blocks_grid(C, T, S, span, sms)
    tpt = lib.rakau_shared_blocks_targets_per_thread()
    threads = lib.rakau_shared_blocks_threads()
    items = int(plan.n_work[0]) * -(-T // (threads * tpt))
    return run, dict(
        span=span, step=lib.rakau_shared_blocks_step(),
        targets_per_thread=tpt, threads=threads, blocks=int(plan.cnt.sum()),
        spans=int(plan.n_work[0]), work_items=items, cuda_blocks=grid,
        blocks_per_sm_fit=lib.rakau_shared_blocks_blocks_per_sm(),
        warps_per_sm=threads // 32 * min(grid, items) / sms,
        processed_pairs=int(plan.cnt.sum()) * shared.BLOCK * T,
        device_plan_equal=all(torch.equal(x, y) for x, y in
                              zip(dplan[:4], plan[:4])))


BLOCKS_MACROS = ("RAKAU_STEP", "RAKAU_TPT", "RAKAU_UNROLL", "RAKAU_THREADS")


def blocks_builds(sweep: str) -> dict:
    """label -> csrc/shared_blocks.cu built with the macros of each
    STEP:TPT:UNROLL:THREADS of `sweep` (trailing fields may be left out:
    the source's defaults), built together."""
    from rakau_tpu_torch.kernels import shared
    vs = [v for v in sweep.split(",") if v]

    def one(v):
        path = shared.build_library("shared_blocks", macros=tuple(
            f"-D{m}={x}" for m, x in zip(BLOCKS_MACROS, v.split(":"))))
        return f"build{v}", shared.bind_library(path, "shared_blocks")
    with ThreadPoolExecutor(max(1, len(vs))) as ex:
        return dict(ex.map(one, vs))


def ab_k5(args, dev, card) -> tuple:
    """K5 on the shared+grid chunks against the other checkout's, at other
    spans and in other builds. Returns (lines, summary)."""
    from rakau_tpu_torch.kernels import shared
    spans = [int(x) for x in args.blocks_spans.split(",") if x]
    root = args.other.resolve()
    planned = "int span" in c_signature(root, "shared_blocks",
                                        "rakau_shared_blocks")
    with ThreadPoolExecutor(2) as ex:
        other_f = ex.submit(compile_other, root, "shared_blocks")
        this = shared._library("shared_blocks")
        other = bind_some(other_f.result(), "shared_blocks")
    builds = blocks_builds(args.blocks_sweep)
    lines, ratios = [], {}
    for label, ch, row in shared_rows(args.n, args.seed, dev):
        span = shared.BLOCKS_SPAN
        run_o = (this_blocks(other, row, span)[0] if planned
                 else other_blocks(other, row))
        run_t, shape = this_blocks(this, row, span)
        variants = [(f"span{sp}", this_blocks(this, row, sp)[0])
                    for sp in spans if sp != span]
        variants += [(lv, this_blocks(lib_v, row, span)[0])
                     for lv, lib_v in builds.items()]
        rec = compare_ab(dict(kernel="K5", config=label, chunk=ch,
                              C=int(row[0].shape[0]), T=int(row[0].shape[1]),
                              S=int(row[2].shape[0]), **shape),
                         run_o, run_t, args.reps, variants)
        rec["processed_gpairs_per_s"] = shape["processed_pairs"] / (
            rec["this_ms"][0] * 1e6)
        ratios.setdefault(label, []).append(rec["ratio"])
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    return lines, dict(blocks_span=shared.BLOCKS_SPAN,
                       other_k5_planned=planned,
                       k5_ratio_this_over_other=ratios)


def other_pairwise(lib, a):
    """The other checkout's K4 as the static split of each row (no G): one
    launch a row and the add, into its own outputs."""
    from rakau_tpu_torch.kernels import shared, tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = a
    C, T, _ = tp.shape
    f64 = tp.dtype == torch.float64
    fn = lib.rakau_tiles_split
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [_real(f64), ctypes.c_void_p])
    sms = shared.multiprocessors(tp.device)
    stream = torch.cuda.current_stream().cuda_stream
    launches = []
    for pos, mass, idx, cnt in ((mp, mm, None, mc), (pp, pm, pi, pc)):
        S = pos.shape[1]
        b = min(tiles.BLOCK, S)
        nsplit = split_nsplit(C, T, -(-S // b), sms)
        scratch = torch.empty((nsplit, C, T, 4), dtype=tp.dtype,
                              device=tp.device)
        out = (torch.empty((C, T, 3), dtype=tp.dtype, device=tp.device),
               torch.empty((C, T), dtype=tp.dtype, device=tp.device))
        launches.append((pos, mass, idx, cnt.to(torch.int64), S, b, nsplit,
                         scratch, out))

    def run():
        for pos, mass, idx, cnt, S, b, nsplit, scratch, out in launches:
            err = fn(tp.data_ptr(), ti.data_ptr(), pos.data_ptr(),
                     mass.data_ptr(), None if idx is None else idx.data_ptr(),
                     cnt.data_ptr(), scratch.data_ptr(), out[0].data_ptr(),
                     out[1].data_ptr(), C, T, S, b, nsplit, 0.0, stream)
            if err:
                raise RuntimeError(f"other K4 launch failed: {err}")
        (am, pmo), (ap, ppo) = launches[0][-1], launches[1][-1]
        return am + ap, pmo + ppo
    return run


def this_pairwise(lib, a, span: int):
    """This side's K4 (two whole launches, one a row: each its plan, kernel
    and reduction in one C call, and the add) on one chunk's rows at
    `span`, the plan tensors and the workspaces made here; and the launch
    shape, with the plans its kernel builds against pairwise_plan's."""
    from rakau_tpu_torch.kernels import rows, shared, tiles
    tp, ti, mp, mm, mc, pp, pm, pi, pc = a
    C, T, _ = tp.shape
    dev = tp.device
    sms = shared.multiprocessors(dev)
    stream = torch.cuda.current_stream().cuda_stream
    launches, shape = [], dict(span=span, granules=0, spans=0, work_items=0,
                               cuda_blocks=0, device_plan_equal=True)
    per_item = -(-T // (128 * lib.rakau_tiles_targets_per_thread()))
    for pos, mass, idx, cnt in ((mp, mm, None, mc), (pp, pm, pi, pc)):
        S = pos.shape[1]
        cap = tiles.pairwise_capacity(C, S, span)
        plan = rows.plan_views(torch.empty(C + cap + 2, dtype=torch.int32,
                                           device=dev), C, cap)
        ws = torch.empty(lib.rakau_tiles_workspace(T, cap), dtype=torch.uint8,
                         device=dev)
        out = (torch.empty((C, T, 3), dtype=tp.dtype, device=dev),
               torch.empty((C, T), dtype=tp.dtype, device=dev))
        launches.append((pos, mass, idx, cnt.to(torch.int64), S, cap, plan,
                         ws, out))
        want = tiles.pairwise_plan(C, S, cnt, span=span)
        grid = lib.rakau_tiles_pairwise_grid(cap, T, sms)
        shape["granules"] += int(tiles.pairwise_granules(C, S, cnt).sum())
        shape["spans"] += int(want.n_work[0])
        shape["work_items"] += int(want.n_work[0]) * per_item
        shape["cuda_blocks"] += grid

    def run():
        for pos, mass, idx, cnt, S, cap, plan, ws, out in launches:
            err = lib.rakau_tiles_pairwise(
                tp.data_ptr(), ti.data_ptr(), pos.data_ptr(),
                mass.data_ptr(), None if idx is None else idx.data_ptr(),
                cnt.data_ptr(), *(t.data_ptr() for t in plan), ws.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), C, T, S, tiles.BLOCK,
                span, cap, sms, 0.0, stream)
            if err:
                raise RuntimeError(f"K4 launch failed: {err}")
        (am, pmo), (ap, ppo) = launches[0][-1], launches[1][-1]
        return am + ap, pmo + ppo
    run()
    for pos, mass, idx, cnt, S, cap, plan, ws, out in launches:
        want = tiles.pairwise_plan(C, S, cnt, span=span)
        shape["device_plan_equal"] &= all(torch.equal(x, y)
                                          for x, y in zip(plan, want))
    return run, shape


def ab_k4(args, dev, card) -> tuple:
    """K4 (one lists chunk: its two launches and the add) on the lists
    chunks against the other checkout's, at other spans and in other
    builds. Returns (lines, summary)."""
    from rakau_tpu_torch.kernels import tiles
    spans = [int(x) for x in args.pairwise_spans.split(",") if x]
    root = args.other.resolve()
    planned = "int span" in c_signature(root, "tiles",
                                        "rakau_tiles_pairwise")
    others, this = tiles_libraries(root)
    builds = rows_builds("tiles", args.rows_sweep)
    lines, ratios = [], {}
    for label, ch, a in lists_chunks(args.n, args.seed, dev):
        f64 = a[0].dtype == torch.float64
        run_o = (this_pairwise(others[f64], a, tiles.SPAN)[0] if planned
                 else other_pairwise(others[f64], a))
        run_t, shape = this_pairwise(this[f64], a, tiles.SPAN)
        variants = [(f"span{sp}", this_pairwise(this[f64], a, sp)[0])
                    for sp in spans if sp != tiles.SPAN and not f64]
        if not f64:
            variants += [(label_v, this_pairwise(lib_v, a, tiles.SPAN)[0])
                         for label_v, lib_v in builds.items()]
        rec = compare_ab(dict(kernel="K4", config=label, chunk=ch,
                              dtype="float64" if f64 else "float32",
                              C=int(a[0].shape[0]), T=int(a[0].shape[1]),
                              Sm=int(a[2].shape[1]), Sp=int(a[5].shape[1]),
                              **shape),
                         run_o, run_t, args.reps, variants)
        ratios.setdefault(label, []).append(rec["ratio"])
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    return lines, dict(pairwise_span=tiles.SPAN, other_k4_planned=planned,
                       k4_ratio_this_over_other=ratios)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--kernels", default="k1,k2,k3")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--sweep", default="",
                    help="GRANULE:TPT,... builds of K1's source to time")
    ap.add_argument("--spans", default="",
                    help="span lengths to time each K1 sweep build at")
    ap.add_argument("--pool-spans", default="",
                    help="K2 span lengths to time beside the default")
    ap.add_argument("--tiles-spans", default="",
                    help="K3 span lengths to time beside the default")
    ap.add_argument("--rows-sweep", default="",
                    help="TPT:UNROLL:MINB,... builds of K2's and K3's "
                         "sources to time")
    ap.add_argument("--mma-spans", default="",
                    help="K6 span lengths to time beside the default")
    ap.add_argument("--mma-sweep", default="",
                    help="WARPS:SLABS,... builds of K6's source to time")
    ap.add_argument("--blocks-spans", default="",
                    help="K5 span lengths to time beside the default")
    ap.add_argument("--blocks-sweep", default="",
                    help="STEP:TPT:UNROLL:THREADS,... builds of K5's source "
                         "to time")
    ap.add_argument("--pairwise-spans", default="",
                    help="K4 span lengths to time beside the default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []
    summary = dict(card=card, n=args.n, reps=args.reps,
                   other=str(args.other))
    for key, fn in (("k1", ab_k1), ("k2", ab_k2), ("k3", ab_k3),
                    ("k4", ab_k4), ("k5", ab_k5), ("k6", ab_k6)):
        if key in args.kernels.split(","):
            got, summ = fn(args, dev, card)
            lines += got
            summary.update(summ)
    print(card)
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r)
                                      for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
