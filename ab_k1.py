"""Time the float32 forms of the shared-row kernel K1
(rakau_tpu_torch/csrc/shared_fused.cu) of this checkout against those of
another checkout, on the same inputs on one CUDA card, and sweep this
checkout's build options.

    python3 ab_k1.py --other DIR [--n 1048576] [--reps 20] [--out FILE]
                     [--sweep G:TPT:UNROLL:MINB,...] [--spans SPAN,...]

DIR is the root of the other checkout (an unpacked `git archive` of an
earlier commit, say). Its rakau_tpu_torch/csrc/shared_fused.cu is built with
the flags of kernels/shared.py:build_library into
rakau_tpu_torch/_build/other/ and called through ctypes with the launch
signature its source declares (the row-at-a-time signature of the 1024-source
block plan: with or without the cell_dims argument).

The inputs are chunks 0 and 1 of a query of a seeded Plummer sphere of n
particles: the shared traversal, farfield "grid2" (order 4, grid_sep 3),
multipole_order 2, theta 0.75, eps 0. The node rows [0, U) with their
second moments go to the quadrupole forms, the particle rows [U, S) to the
monopole forms, the leaf cells to the cell forms, as the engine hands them
out. Each form and chunk runs other, this, this, other: `reps` launches
each between two CUDA events (the card held busy while the host enqueues
them), the host work (the other's block plan; this
side's plan, fused_plan, and its workspace) done once outside the timing.
This side's time is the whole launch (the plan, the row packing, the main
kernel and the span reduction), `this_kernel_ms` the last two alone, over
a plan and a row made outside the timing. The
sums are not expected to be bit-equal (another order of summation): the
largest difference is reported.

--sweep builds this checkout's source again with -DRAKAU_GRANULE,
-DRAKAU_TPT (targets a thread), -DRAKAU_UNROLL and -DRAKAU_MIN_BLOCKS (the
launch bound's blocks a SM, 0 for none) for each G:TPT:UNROLL:MINB
(trailing fields may be left out: the source's defaults), and times every
build at every span length of --spans (list entries a work item), each
beside the default build (default, variant, variant, default). Prints one
JSON line per form and chunk, the card's name and power limit, and a
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


def build_other(root: Path) -> tuple:
    """(loaded library, takes cell_dims) of root's shared_fused.cu."""
    from rakau_tpu_torch.kernels import shared
    src = root / "rakau_tpu_torch" / "csrc" / "shared_fused.cu"
    out_dir = shared._BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libshared_fused_other.so"
    cmd = [shared._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(out), str(src)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    text = src.read_text()
    sig = text[text.index('extern "C" int rakau_shared_fused('):]
    dims = "int cell_dims" in sig[:sig.index("{")]
    lib = ctypes.CDLL(str(out))
    fn = lib.rakau_shared_fused
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * (8 if dims else 7)
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib, dims


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--sweep", default="",
                    help="GRANULE:TPT,... builds of this source to time")
    ap.add_argument("--spans", default="",
                    help="span lengths to time each sweep build at")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_k1: no CUDA device", file=sys.stderr)
        return 2
    from rakau_tpu_torch import Tree, engine, particles
    from rakau_tpu_torch.config import TreeConfig
    from rakau_tpu_torch.kernels import shared

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sweep = [tuple(int(x) for x in v.split(":"))
             for v in args.sweep.split(",") if v]
    spans = [int(x) for x in args.spans.split(",") if x] or [shared.SPAN]
    with ThreadPoolExecutor(2) as ex:
        other_f = ex.submit(build_other, args.other.resolve())
        libs = build_this([None] + sweep)
        other_lib, other_dims = other_f.result()
    other = other_lib.rakau_shared_fused
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
            run_o = other_launcher(other, other_dims, a, cfg.grid_sep)
            run_t, kern_t, shape = this_launchers(libs[None], a,
                                                  cfg.grid_sep, shared.SPAN)
            got_o = [t.clone() for t in run_o()]
            got_t = [t.clone() for t in run_t()]
            again = run_t()
            ms = [event_ms(r, args.reps)
                  for r in (run_o, run_t, run_t, run_o)]
            kms = event_ms(kern_t, args.reps)
            scale = max(float(t.abs().max()) for t in got_o)
            C, T, _ = a["tensors"][0].shape
            pairs = shape["granules"] * shape["granule"] * T
            rec = dict(form=form, chunk=chunk,
                       other_active_blocks=int(a["cnt"].sum()),
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
                    t = [event_ms(r, args.reps)
                         for r in (run_t, run_v, run_v, run_t)]
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
    summary = dict(card=card, n=args.n, reps=args.reps,
                   other=str(args.other), other_takes_cell_dims=other_dims,
                   granule=shared.GRANULE, span=shared.SPAN,
                   ratio_this_over_other={f: r for f, r in ratios.items()})
    print(card)
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r)
                                      for r in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
