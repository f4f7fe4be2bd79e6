"""The program's spans against the card's operations.

rakau_tpu_torch opens a `rakau.<name>` range (torch.profiler's
record_function) at each of its layer boundaries while a profiler records
(rakau_tpu_torch/utils/timing.py). A device operation belongs to the span
in which the host made the CUDA runtime call that launched it
(cudaLaunchKernel, cudaGraphLaunch, cudaMemcpyAsync, ...): the call and
the operation carry one correlation id in the profiler's events, and the
spans, the calls and the operations share the profiler's clock.

The traced window's Trace (portbench/trace.py) keeps no correlation ids,
so the span metrics read a call of their own: `of(run)` profiles one more
call of the cell's entry right after the traced window, warm as the
window's calls are, once a run, and keeps its SpanTrace on the run. A
window with no `rakau.*` span (a program without them) makes no such call,
and its span metrics are left out of the line."""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from portbench import trace

PREFIX = "rakau."
CALL = "portbench.span_call"


def _merged(iv: np.ndarray) -> np.ndarray:
    """Intervals [k, 2] as sorted, disjoint ones (their union)."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.empty(len(iv), dtype=bool)
    new[0] = True
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(iv) - 1)
    return np.stack([iv[first, 0], reach[last]], axis=1)


def _inside(t: np.ndarray, merged: np.ndarray) -> np.ndarray:
    """Whether each time of t lies in the union `merged` (_merged's)."""
    if len(merged) == 0:
        return np.zeros(t.shape, dtype=bool)
    i = np.searchsorted(merged[:, 0], t, side="right") - 1
    ok = i >= 0
    return ok & (t <= merged[np.maximum(i, 0), 1])


class SpanTrace(trace.Trace):
    """A Trace (the same device operations, host events and methods) of
    one profiled call, bracketed by the annotation CALL, that also knows
    each device operation's launching runtime call and the program's
    spans."""

    def __init__(self, raw, cards: list):
        dev = {"card": [], "start": [], "end": [], "corr": []}
        dev_names, host, host_names = [], {"start": [], "end": []}, []
        calls = {"corr": [], "start": [], "name": []}
        t0 = t1 = None
        for e in raw:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name == CALL or e.is_user_annotation():
                    continue        # an annotation's span, not an operation
                dev["card"].append(e.device_index())
                dev["start"].append(start)
                dev["end"].append(end)
                dev["corr"].append(e.correlation_id())
                dev_names.append(name)
            elif name == CALL:
                t0, t1 = start, end
            else:
                host["start"].append(start)
                host["end"].append(end)
                host_names.append(name)
                if name.startswith("cu"):
                    # a runtime call: its correlation id is its
                    # operations' (a torch op's numbers are another count)
                    calls["corr"].append(e.correlation_id())
                    calls["start"].append(start)
                    calls["name"].append(name)
        if t0 is None:
            raise RuntimeError("the trace holds no call annotation")
        self.t0, self.t1 = t0, t1
        self.cards = list(cards)
        self.dev = {k: np.asarray(v, dtype=np.int64)
                    for k, v in dev.items() if k != "corr"}
        self.dev_names = dev_names
        self.host = {k: np.asarray(v, dtype=np.int64)
                     for k, v in host.items()}
        self.host_names = host_names
        self._launch(np.asarray(dev["corr"], dtype=np.int64), calls)
        keep = [i for i, n in enumerate(host_names)
                if n.startswith(PREFIX) and t0 <= host["start"][i] <= t1]
        self.span_names = [host_names[i][len(PREFIX):] for i in keep]
        self.span_iv = np.stack([self.host["start"][keep],
                                 self.host["end"][keep]], axis=1) \
            if keep else np.zeros((0, 2), dtype=np.int64)

    def _launch(self, corr: np.ndarray, calls: dict):
        """Each device operation's launching call: its host start
        (`launch_t`, -1 where none was recorded) and name (`launch_by`)."""
        c = np.asarray(calls["corr"], dtype=np.int64)
        if c.size == 0:
            self.launch_t = np.full(corr.shape, -1, dtype=np.int64)
            self.launch_by = [""] * corr.size
            return
        order = np.argsort(c, kind="stable")
        c = c[order]
        i = np.minimum(np.searchsorted(c, corr), c.size - 1)
        found = c[i] == corr
        starts = np.asarray(calls["start"], dtype=np.int64)[order]
        self.launch_t = np.where(found, starts[i], -1)
        names = [calls["name"][j] for j in order]
        self.launch_by = [names[k] if f else "" for k, f in
                          zip(i.tolist(), found.tolist())]

    # ------------------------------------------------------------- spans
    def span_intervals(self, name: str) -> list:
        """Host [start, end] (ns) of every `rakau.<name>` span of the
        call, in order."""
        sel = [k for k, n in enumerate(self.span_names) if n == name]
        return [tuple(self.span_iv[k].tolist()) for k in
                sorted(sel, key=lambda k: self.span_iv[k, 0])]

    def _seconds(self) -> np.ndarray:
        s = np.clip(self.dev["start"], self.t0, self.t1)
        e = np.clip(self.dev["end"], self.t0, self.t1)
        return (e - s) / 1e9

    def _under(self, iv) -> np.ndarray:
        """Which device operations were launched inside the intervals."""
        return _inside(self.launch_t, _merged(np.asarray(iv).reshape(-1, 2)))

    def device_s_under(self, name: str, card: int = None,
                       launched_by=None) -> float:
        """Device seconds of the operations whose launching runtime call
        started inside a `rakau.<name>` span, at any depth below it; on
        one card, and of calls whose name `launched_by` takes, where
        given."""
        keep = self._under(self.span_intervals(name))
        if card is not None:
            keep &= self.dev["card"] == card
        if launched_by is not None:
            keep &= np.fromiter((bool(launched_by(n)) for n in
                                 self.launch_by), dtype=bool,
                                count=len(self.launch_by))
        return float(self._seconds()[keep].sum())

    def coverage(self) -> float:
        """The share of the call's device seconds launched inside some
        `rakau.*` span (1.0 with no device operation)."""
        sec = self._seconds()
        if sec.sum() <= 0:
            return 1.0
        return float(sec[self._under(self.span_iv)].sum() / sec.sum())

    def first_start_under(self, iv, card: int):
        """The start (ns) of the card's first device operation launched
        inside the interval iv, else None."""
        keep = self._under([iv]) & (self.dev["card"] == card)
        return int(self.dev["start"][keep].min()) if keep.any() else None

    # -------------------------------------------------------------- idle
    def _idle_in(self, card: int, a: np.ndarray, b: np.ndarray):
        """The card's idle seconds in each [a, b] (inside the call)."""
        s, e = self._intervals(card)
        if s.size == 0:
            return (b - a) / 1e9
        cum = np.concatenate([[0], np.cumsum(e - s)])

        def busy_before(t):
            # the busy intervals are disjoint and sorted: all those that
            # start at or before t, the last one cut at t
            i = np.searchsorted(s, t, side="right")
            j = np.maximum(i - 1, 0)
            return np.where(i > 0, cum[j] + np.minimum(t, e[j]) - s[j], 0)
        return (b - a - (busy_before(b) - busy_before(a))) / 1e9

    def idle_s_under(self, card: int, name: str) -> float:
        """The card's idle seconds while the host was inside a
        `rakau.<name>` span, at any depth."""
        iv = _merged(np.clip(np.asarray(self.span_intervals(name))
                             .reshape(-1, 2), self.t0, self.t1))
        return float(self._idle_in(card, iv[:, 0], iv[:, 1]).sum())

    def idle_by_span(self, card: int) -> dict:
        """{span: the card's idle seconds while it was the host's innermost
        `rakau.*` span, "outside": while there was none}, over the call."""
        iv = np.clip(self.span_iv, self.t0, self.t1)
        pts = np.unique(np.concatenate([[self.t0, self.t1], iv.ravel()]))
        a, b = pts[:-1], pts[1:]
        idle = self._idle_in(card, a, b)
        if not self.span_names:
            return {"outside": float(idle.sum())}
        mid = (a + b) / 2
        live = (iv[:, :1] <= mid) & (iv[:, 1:] >= mid)        # [spans, seg]
        # the innermost: the live span that started last, of two that
        # started together the one that ends first
        start = np.where(live, iv[:, :1], np.iinfo(np.int64).min)
        last = live & (iv[:, :1] == start.max(0))
        inner = np.argmin(np.where(last, iv[:, 1:], np.iinfo(np.int64).max),
                          axis=0)
        out: dict = {}
        for k, has, sec in zip(inner.tolist(), live.any(0).tolist(),
                               idle.tolist()):
            key = self.span_names[k] if has else "outside"
            out[key] = out.get(key, 0.0) + sec
        return out


@contextmanager
def _profiled(cards: list):
    """Profile the block (CPU and CUDA activity) bracketed by CALL, every
    card synchronised at both ends; yields a list that holds the
    SpanTrace and the seconds its reading took once the block ended."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    trace._sync_all()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with torch.profiler.record_function(CALL):
            yield out
            trace._sync_all()
    finally:
        prof.stop()
    t = time.perf_counter()
    out.append(SpanTrace(prof.profiler.kineto_results.events(), cards))
    out.append(time.perf_counter() - t)


def has_spans(tr) -> bool:
    """Whether a trace's host events hold a span of the program."""
    return tr is not None and any(n.startswith(PREFIX)
                                  for n in tr.host_names)


def of(run):
    """The run's SpanTrace: one more call of its entry, profiled after
    the traced window (not counted among the window's calls, judged with
    them), made at the first ask and kept on the run; None where the
    window holds no span of the program. Says what it read on standard
    error: the share of device time under spans, the captures in the
    window and in the call, each card's idle by span."""
    if "_span_trace" not in vars(run):
        run._span_trace = None
        if has_spans(run.trace):
            run._span_trace = _call(run)
    return run._span_trace


def _call(run) -> SpanTrace:
    entry = run.entry
    with _profiled(entry.cards) as out:
        entry._call()
    st, read_s = out
    window_captures = sum(n == PREFIX + "graph.capture"
                          for n in run.trace.host_names)
    run.say(span_window_s=st.window_s, span_trace_read_s=read_s,
            span_coverage=st.coverage(),
            graph_captures={"window": window_captures,
                            "span_call": len(st.span_intervals(
                                "graph.capture"))},
            device_s_under={n: st.device_s_under(n) for n in
                            ("step", "build", "query", "graph.replay")},
            busy_s={c: st.busy_s(c) for c in st.cards},
            idle_by_span={c: st.idle_by_span(c) for c in st.cards})
    return st
