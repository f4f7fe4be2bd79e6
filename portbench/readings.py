"""The readings that the checks' limits are set from: one cell over many
seeds in one process (set-up is most of a run), each seed a short window
of the cell's own traffic at its own size, judged as a run judges it;
with --control, the same under the control (bf16: the program's bf16
tensor-core form of K1 in K1a's place; ref-bf16: the reference in
bfloat16 in the program's place); with --fault, under a fault of
portbench/faults.py planted in the program for the whole process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--control bf16 | --fault <name>] \
        [--out chiprun_out/<file>.jsonl]

Prints a JSON line a seed: the checks' values, the diagnostics, set-up
and window seconds. Not run by the benchmark's own runs."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import faults, harness
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(harness._json(ROOT / "BENCHMARK.json"),
                        args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res, run = harness.run_cell(cell, seed, args.seconds, False, t,
                                    control=args.control)
        line = json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "fault": args.fault,
            "checks": {k: v["value"] for k, v in res["checks"].items()},
            "diagnostics": run.diagnostics, "calls": res["attempted"],
            "setup_s": run.setup_s, "window_s": run.window_s,
            "peak_gb": run.memory_peak / 1e9,
            "seconds": time.perf_counter() - t}, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run, res
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
