"""One run of one cell: resolve the cell by name, set up, measure, read the
metrics, judge the outputs, print the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in BENCHMARK.json:
  portbench/configs/<config>.json   sizes, TreeConfig keywords, theta, eps
  portbench/traffic/<traffic>.json  the driver and its parameters
  portbench/drivers/<driver>.py     Driver: set-up, a call, the window's
                                    loop and the judgement (entries.Entry)
  portbench/limits/<cell>.json      the sample sizes and each check's limit
  portbench/metrics/<metric>.py     read(run) -> number or None
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import entries, trace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rakau_tpu")


class Cell:
    """A workload of BENCHMARK.json with its files and metrics."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name, self.chips = name, w["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = _json(HERE.parent / conf["file"])
        self.traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
        self.limits = _json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def _json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(name: str):
    """The read(run) function of portbench/metrics/<name>.py."""
    return entries.load("metrics", name, "read")


class Run:
    """What a metric reader may read: the cell, the entry (the program's
    objects after the window), the window, the trace and the judgement."""

    def __init__(self, cell: Cell, entry, seconds: float, setup_s: float):
        self.cell, self.entry = cell, entry
        self.window_s = seconds
        self.setup_s = setup_s
        self.trace = None
        self.diagnostics = {}

    @property
    def calls(self) -> int:
        return self.entry.calls

    def say(self, **kw):
        """A line of the run's own diagnostics on standard error."""
        print(json.dumps(kw, default=str), file=sys.stderr, flush=True)


def card_line() -> str:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device: str = "cuda", n: int = None,
             control: str = None) -> tuple:
    """Set up, measure (or trace), read, judge. Returns the result line
    (without `device`) and the Run. `control`, for the checks' controls
    (the benchmark's own runs never set it): "bf16", the program's own
    tensor-core form of K1 in one bf16 pass (kernels.dispatch
    .shared_variant("mma", "bf16")) in K1a's place throughout; "ref-bf16",
    the reference computed in bfloat16 in the program's place when the
    outputs are judged."""
    if control == "bf16":
        from rakau_tpu_torch.kernels import dispatch
        with dispatch.shared_variant("mma", "bf16"):
            return _run_cell(cell, seed, seconds, traced, t_start, device,
                             n, None)
    if control not in (None, "ref-bf16"):
        raise ValueError(f"unknown control {control!r}")
    return _run_cell(cell, seed, seconds, traced, t_start, device, n,
                     torch.bfloat16 if control else None)


def _run_cell(cell, seed, seconds, traced, t_start, device, n,
              control_dtype) -> tuple:
    entry = entries.make(cell.config, cell.traffic, cell.limits, seed,
                         device, n)
    entry.control_dtype = control_dtype
    entry.setup()
    setup_s = time.perf_counter() - t_start
    run = Run(cell, entry, 0.0, setup_s)
    run.say(setup_s=setup_s, **entry.info)
    if traced:
        with trace.traced(entry.cards) as out:
            t0 = time.perf_counter()
            for _ in range(cell.traffic["traced_calls"]):
                entry.call()
            run.window_s = time.perf_counter() - t0
        run.trace, read_s = out
        run.say(trace_read_s=read_s, trace_window_s=run.trace.window_s,
                device_ops=len(run.trace.dev_names))
    else:
        run.window_s = entry.measure(seconds)
    run.memory_peak = (max(torch.cuda.max_memory_allocated(c)
                           for c in entry.cards)
                       if device == "cuda" else 0)
    metrics = {}
    if traced:
        metrics.update(_read(run, cell.per_layer))
    checks, run.diagnostics = entry.judge()
    if not traced:
        metrics.update(_read(run, cell.end_to_end))
    run.say(call_s=entry.call_s, **run.diagnostics)
    verdicts = {k: {"value": v, "limit": cell.limits["checks"][k]}
                for k, v in checks.items()}
    failed = entry.failed()
    # a call that returned truncated sums fails the run whatever it read
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in verdicts.values())
    for k, v in verdicts.items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    result = {"correct": correct, "attempted": entry.calls,
              "failed": failed, "metrics": metrics}
    if traced:
        result["busy_s"] = run.trace.mean_busy_s()
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = verdicts
    return result, run


def _read(run: Run, specs: list) -> dict:
    out = {}
    for m in specs:
        v = load_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(args, t_start: float) -> int:
    root = HERE.parent
    bench = _json(root / "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    print(f"cards: {card_line()}", file=sys.stderr, flush=True)
    result, run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           t_start)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}", file=sys.stderr)
        return 3
    cards = run.entry.cards
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]),
           "count": len(cards), "memory_peak_bytes": run.memory_peak}
    if args.trace:
        dev["busy_s"] = result.pop("busy_s")
        dev["window_s"] = run.trace.window_s
    checks = result.pop("checks")
    line = dict(result, device=dev, checks=checks)
    print(json.dumps(line), flush=True)
    return 0
