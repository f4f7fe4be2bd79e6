"""What every driver of the benchmark's traffic shares, and the lookup of
a driver by name.

A traffic file portbench/traffic/<mix>.json names its driver ("driver"),
a file portbench/drivers/<driver>.py whose class `Driver` subclasses
`Entry`, and gives its parameters: how many calls warm it up
("warm_calls", and "warm_s" seconds of calls at the least) and make a
traced window ("traced_calls"). A new mix of an existing driver is a
data file; a new kind of traffic adds a driver file.

A driver makes its inputs from the seed (portbench.inputs), builds and
warms the program at set-up (`setup`), runs one call a `call()`, keeps
what the check needs from every call, and after the window judges it
against the plain reference (`judge`). `measure` is the window's loop.

The program is `rakau_tpu_torch`; nothing here imports the JAX package."""
from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import torch

from . import inputs
from .reference import compare
from .reference.direct import direct_sum

HERE = Path(__file__).resolve().parent


def _sync(cards: list):
    for c in cards:
        if c is not None:
            torch.cuda.synchronize(c)


def load(folder: str, name: str, attr: str):
    """`attr` of the module portbench/<folder>/<name>.py, loaded from its
    file (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} file {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


class Entry:
    """What every driver shares: the configuration, the sample of targets,
    the warm-up, the closed loop and the records of the calls."""

    # whether the set-up's first "warm_calls" calls are judged with the
    # window's
    judge_setup = False

    def __init__(self, config: dict, traffic: dict, limits: dict,
                 seed: int, device: str = "cuda", n: int = None):
        from rakau_tpu_torch.config import TreeConfig
        self.config, self.traffic, self.limits = config, traffic, limits
        self.seed = seed
        self.device = torch.device(device)
        self.n = config["n"] if n is None else n
        self.theta = config["theta"]
        self.eps = config["eps"]
        self.G = config["G"]
        self.cfg = self.cfg0 = TreeConfig(**config["tree"])
        self.calls = 0
        self.records = []
        self.info = {}
        # the checks' control: the reference in this precision takes the
        # program's answers' place when judged (readings only)
        self.control_dtype = None
        self.call_s = []

    @property
    def cards(self) -> list:
        return [self.device.index or 0] if self.device.type == "cuda" \
            else [None]

    def particles(self):
        return inputs.particles(self.config, self.seed, self.device, self.n)

    def sync(self):
        if self.device.type == "cuda":
            _sync(self.cards)

    def warm(self):
        """The traffic's "warm_calls" calls, and more until "warm_s"
        seconds of calls have passed (the card's first seconds of load
        run slower than the rest: PERF.md, section 2)."""
        t0 = time.perf_counter()
        kept = self.traffic["warm_calls"] if self.judge_setup else 0
        while (self.calls < self.traffic["warm_calls"] or
               time.perf_counter() - t0 < self.traffic.get("warm_s", 0)):
            self.call()
            # judged with the window's: the first "warm_calls" calls of a
            # driver that judges its set-up, no other warm call
            del self.records[kept:]
        self.calls = 0
        self.info["warm_call_s"] = self.call_s
        self.call_s = []

    def call(self):
        """One call of the entry, run to its end on the card, counted, its
        seconds kept."""
        t = time.perf_counter()
        self._call()
        self.sync()
        self.call_s.append(time.perf_counter() - t)
        self.calls += 1

    def measure(self, seconds: float) -> float:
        """The window, a closed loop: calls until `seconds` have passed,
        the last one run to its end. Returns the window's seconds, from
        its first call's start to its last call's end."""
        t0 = time.perf_counter()
        while True:
            self.call()
            t = time.perf_counter() - t0
            if t >= seconds:
                return t

    def failed(self) -> int:
        """Calls that returned truncated sums."""
        return 0

    def free(self):
        """Drop the program's graphs and state (what the reference must
        not share the card with)."""
        from rakau_tpu_torch import engine
        engine.clear_graphs()
        engine._QUERY_STATE_CACHE.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def grown(start, now) -> dict:
    from rakau_tpu_torch.config import OVF_FIELDS
    return {f: getattr(now, f) for f in OVF_FIELDS
            if getattr(now, f) != getattr(start, f)}


def judge_answers(entry, records) -> tuple:
    """The reference at the sampled targets of the entry's inputs, made
    anew from the seed, against each call's answers there (under the
    control: against the reference's own in the control's precision)."""
    pos, mass = entry.particles()
    tgt = (pos, mass, pos[entry.samp], entry.samp, entry.eps, entry.G)
    if entry.control_dtype is not None:
        records = [direct_sum(*tgt, dtype=entry.control_dtype)]
    return _answers(records, direct_sum(*tgt))


def _answers(records, ref) -> tuple:
    """(checks, diagnostics) of calls that each answered the sampled
    targets: the widest answer error over the calls and targets is the
    check; the force error of the last call is BASELINE's."""
    per = [compare.answers(a, p, *ref) for a, p in records]
    return ({"answer_max": max(r["answer_max"] for r in per)},
            {"force_err_rms": per[-1]["force_rms"],
             "pot_rms": per[-1]["pot_rms"],
             "answer_rms": max(r["answer_rms"] for r in per),
             "calls_judged": len(per)})


def make(config: dict, traffic: dict, limits: dict, seed: int,
         device: str = "cuda", n: int = None) -> Entry:
    """The traffic's driver, portbench/drivers/<traffic["driver"]>.py."""
    driver = load("drivers", traffic["driver"], "Driver")
    return driver(config, traffic, limits, seed, device, n)
