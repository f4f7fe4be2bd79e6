"""Time the float32 forms of the shared-row kernel K1
(rakau_tpu_torch/csrc/shared_fused.cu) of this checkout against those of
another checkout, on the same inputs on one CUDA card.

    python3 ab_k1.py --other DIR [--n 1048576] [--reps 20] [--out FILE]

DIR is the root of the other checkout (an unpacked `git archive` of an
earlier commit, say). Its rakau_tpu_torch/csrc/shared_fused.cu is built with
the flags of kernels/shared.py:build_library into
rakau_tpu_torch/_build/other/ and called through ctypes with the launch
signature its source declares (with or without the cell_dims argument).

The inputs are chunks 0 and 1 of a query of a seeded Plummer sphere of n
particles: the shared traversal, farfield "grid2" (order 4, grid_sep 3),
multipole_order 2, theta 0.75, eps 0. The node rows [0, U) with their
second moments go to the quadrupole forms, the particle rows [U, S) to the
monopole forms, the leaf cells to the cell forms, as the engine hands them
out. Each form and chunk runs other, this, this, other: `reps` launches
each between two CUDA events, the wrapper's host work (the block plan, the
outputs) done once outside the timing. Prints one JSON line per form and
chunk, the card's name and power limit, and a summary line; with --out,
writes them all to that file too.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
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


def form_args(inp, form: str) -> dict:
    """The rows, the options and the block plan of `form` on one chunk's
    kernel inputs (engine.kernel_inputs)."""
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


def launcher(fn, dims: bool, a: dict, sep: int):
    """A closure that launches fn on `a` into its own outputs."""
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


def event_ms(run, reps: int) -> float:
    run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
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
    other_lib, other_dims = build_other(args.other.resolve())
    other = other_lib.rakau_shared_fused
    this = shared._library("shared_fused").rakau_shared_fused
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
            run_o = launcher(other, other_dims, a, cfg.grid_sep)
            run_t = launcher(this, True, a, cfg.grid_sep)
            got_o = [t.clone() for t in run_o()]
            got_t = run_t()
            diff = max(float((x - y).abs().max())
                       for x, y in zip(got_o, got_t))
            ms = [event_ms(r, args.reps)
                  for r in (run_o, run_t, run_t, run_o)]
            rec = dict(form=form, chunk=chunk,
                       active_blocks=int(a["cnt"].sum()),
                       other_ms=[ms[0], ms[3]], this_ms=[ms[1], ms[2]],
                       ratio=(ms[1] + ms[2]) / (ms[0] + ms[3]),
                       max_abs_diff=diff)
            ratios.setdefault(form, []).append(rec["ratio"])
            lines.append(rec)
            print(json.dumps(rec), flush=True)
    summary = dict(card=card, n=args.n, reps=args.reps,
                   other=str(args.other), other_takes_cell_dims=other_dims,
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
