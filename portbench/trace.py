"""The device trace of a traced window, read from torch.profiler's raw
(kineto) events: each card's busy intervals, the device operations by
name and the idle gaps by what the host was doing.

The raw events are read directly (`kineto_results.events()`), not through
the profiler's function-event tree, which takes minutes to build for the
million and more device operations of one 8M query."""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

WINDOW = "portbench.window"
# the port's own CUDA kernels (rakau_tpu_torch/csrc), by the names of
# their __global__ functions
PORT_KERNELS = ("shared_fused", "shared_mma", "shared_blocks", "pool_kernel",
                "rows_work", "rows_reduce", "tiles_fused", "tiles_pairwise")
TOP = 10
NAME_CHARS = 160


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def _sync_all():
    for d in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        torch.cuda.synchronize(d)


class Trace:
    """Device operations [(card, start ns, end ns, name)] and host events
    (start ns, end ns, name, is a CUDA runtime call) of one traced window
    [t0, t1] (ns, the profiler's clock)."""

    def __init__(self, raw, cards: list):
        dev = {"card": [], "start": [], "end": [], "name": []}
        host = {"start": [], "end": [], "name": []}
        t0 = t1 = None
        for e in raw:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name == WINDOW or getattr(e, "is_user_annotation",
                                             lambda: False)():
                    continue        # an annotation's span, not an operation
                dev["card"].append(e.device_index())
                dev["start"].append(start)
                dev["end"].append(end)
                dev["name"].append(name)
            elif name == WINDOW:
                t0, t1 = start, end
            else:
                host["start"].append(start)
                host["end"].append(end)
                host["name"].append(name)
        if t0 is None:
            raise RuntimeError("the trace holds no window annotation")
        self.t0, self.t1 = t0, t1
        self.cards = list(cards)
        self.dev = {k: np.asarray(v) for k, v in dev.items()
                    if k != "name"}
        self.dev_names = dev["name"]
        self.host = {k: np.asarray(v) for k, v in host.items()
                     if k != "name"}
        self.host_names = host["name"]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _intervals(self, card: int):
        """The card's device operations clipped to the window, as sorted,
        merged busy intervals (starts, ends)."""
        sel = self.dev["card"] == card
        s = np.clip(self.dev["start"][sel], self.t0, self.t1)
        e = np.clip(self.dev["end"][sel], self.t0, self.t1)
        keep = e > s
        s, e = s[keep], e[keep]
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        if s.size == 0:
            return s, e
        reach = np.maximum.accumulate(e)
        new = np.empty(s.size, dtype=bool)
        new[0] = True
        new[1:] = s[1:] > reach[:-1]
        first = np.flatnonzero(new)
        last = np.append(first[1:] - 1, s.size - 1)
        return s[first], reach[last]

    def busy_s(self, card: int) -> float:
        """Seconds of the window in which an operation ran on the card."""
        s, e = self._intervals(card)
        return float((e - s).sum()) / 1e9

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(c) for c in self.cards) / len(self.cards)

    def idle_pct(self, card: int = None) -> float:
        """100 x (1 - busy / window), of one card or the cards' mean."""
        busy = self.mean_busy_s() if card is None else self.busy_s(card)
        return 100.0 * (1.0 - busy / self.window_s)

    def op_seconds(self, select) -> float:
        """Summed device seconds of the operations whose name `select`
        takes, inside the window."""
        s = np.clip(self.dev["start"], self.t0, self.t1)
        e = np.clip(self.dev["end"], self.t0, self.t1)
        keep = np.fromiter((bool(select(n)) for n in self.dev_names),
                           dtype=bool, count=len(self.dev_names))
        return float((e - s)[keep].sum()) / 1e9

    def top_ops(self, k: int = TOP) -> list:
        """[[name, seconds]] of the k device operations (by name, summed
        over the cards) that took longest."""
        s = np.clip(self.dev["start"], self.t0, self.t1)
        e = np.clip(self.dev["end"], self.t0, self.t1)
        by: dict = {}
        for name, d in zip(self.dev_names, (e - s).tolist()):
            by[name] = by.get(name, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:NAME_CHARS], d / 1e9] for n, d in top]

    def _host_at(self, t: int) -> str:
        """What the host was doing at time t: the innermost CUDA runtime
        call in progress, else the innermost host event, else "host"."""
        if not self.host_names:
            return "host"
        live = np.flatnonzero((self.host["start"] <= t)
                              & (self.host["end"] >= t))
        if live.size == 0:
            return "host"
        runtime = [i for i in live if self.host_names[i].startswith("cu")]
        pick = runtime or list(live)
        inner = max(pick, key=lambda i: self.host["start"][i])
        return self.host_names[inner][:NAME_CHARS]

    def idle_gaps(self, k: int = TOP) -> list:
        """[[what the host was doing, seconds]] of the k longest gaps of
        the window in which a card ran nothing (every card's gaps, each
        named at its middle, the card's index before the name)."""
        gaps = []
        for c in self.cards:
            s, e = self._intervals(c)
            lo = np.concatenate([[self.t0], e])
            hi = np.concatenate([s, [self.t1]])
            for a, b in zip(lo.tolist(), hi.tolist()):
                if b > a:
                    gaps.append((b - a, a, c))
        gaps.sort(reverse=True)
        return [[f"cuda:{c} {self._host_at(a + d // 2)}", d / 1e9]
                for d, a, c in gaps[:k]]


@contextmanager
def traced(cards: list):
    """Profile the block (CPU and CUDA activity) as the traced window:
    every card synchronised at both ends. Yields a list that holds the
    Trace once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    _sync_all()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW):
            yield out
            _sync_all()
    finally:
        prof.stop()
    t = time.perf_counter()
    out.append(Trace(prof.profiler.kineto_results.events(), cards))
    out.append(time.perf_counter() - t)
