"""portbench's reading of the program's spans (portbench/spans.py) on a
synthetic list of kineto-like events: device operations put down to the
span whose runtime call launched them (by correlation id, a torch op's
own numbers ignored), at any depth; the coverage; idle by innermost span
and under a span; the five span metrics' readers; and portbench/trace.py's
Trace reading the same busy and operation times with the program's
`rakau.*` events present as without them."""
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, spans, trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Ev:
    """One kineto event as portbench reads it."""

    def __init__(self, name, start, end, card=None, corr=0, note=False):
        self._name, self._start, self._dur = name, start, end - start
        self._card, self._corr, self._note = card, corr, note

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return CPU if self._card is None else CUDA

    def device_index(self):
        return -1 if self._card is None else self._card

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._note


def _spans():
    """The program's host spans: a step with a build (its read) and a
    query (a replay, a shard), on the host's [0, 1000] ns."""
    return [Ev("rakau.step", 10, 900, note=True),
            Ev("rakau.build", 20, 300, note=True),
            Ev("rakau.read.build_overflow", 250, 300, note=True),
            Ev("rakau.query", 310, 800, note=True),
            Ev("rakau.graph.replay", 320, 400, note=True),
            Ev("rakau.shard", 420, 700, note=True)]


def _work():
    """Runtime calls and the operations they launched on cards 0 and 1,
    and torch ops whose own numbers collide with the calls'."""
    return [Ev("cudaLaunchKernel", 30, 35, corr=102),
            Ev("kernel_build", 40, 240, card=0, corr=102),
            Ev("cudaMemcpyAsync", 330, 335, corr=100),
            Ev("Memcpy DtoD (Device -> Device)", 340, 360, card=0,
               corr=100),
            Ev("cudaGraphLaunch", 350, 356, corr=101),
            Ev("graph_kernel_a", 360, 380, card=0, corr=101),
            Ev("graph_kernel_b", 380, 420, card=0, corr=101),
            Ev("cudaLaunchKernel", 430, 436, corr=104),
            Ev("shard_kernel", 500, 600, card=1, corr=104),
            Ev("aten::copy_", 330, 334, corr=103),
            Ev("cudaLaunchKernel", 950, 952, corr=103),
            Ev("outside_kernel", 955, 965, card=0, corr=103)]


def _device_notes():
    """The profiler's device-side copies of the annotations."""
    return [Ev("rakau.build", 40, 240, card=0, note=True),
            Ev("rakau.query", 340, 600, card=0, note=True)]


@pytest.fixture
def st():
    raw = ([Ev(spans.CALL, 0, 1000, note=True)] + _spans() + _work()
           + _device_notes())
    return spans.SpanTrace(raw, [0, 1])


def test_device_time_goes_to_the_launching_span(st):
    assert st.span_intervals("build") == [(20, 300)]
    assert st.device_s_under("build") == pytest.approx(200e-9)
    # nested spans count below their parents, on every card
    assert st.device_s_under("step") == pytest.approx(380e-9)
    assert st.device_s_under("query") == pytest.approx(180e-9)
    assert st.device_s_under("query", card=1) == pytest.approx(100e-9)
    # aten::copy_'s 103 inside the replay is not the kernel's runtime call
    assert st.device_s_under("graph.replay") == pytest.approx(80e-9)
    assert st.device_s_under(
        "graph.replay", launched_by=lambda n: "GraphLaunch" not in n) \
        == pytest.approx(20e-9)
    assert st.device_s_under("tail") == 0.0
    assert st.coverage() == pytest.approx(380 / 390)
    assert st.first_start_under(st.span_intervals("shard")[0], 1) == 500
    assert st.first_start_under(st.span_intervals("shard")[0], 0) is None


def test_idle_by_innermost_span(st):
    # card 1 ran [500, 600] of the call's [0, 1000]
    assert st.idle_s_under(1, "build") == pytest.approx(280e-9)
    assert st.idle_s_under(1, "query") == pytest.approx(390e-9)
    by = st.idle_by_span(1)
    assert by == pytest.approx({
        "outside": 110e-9, "step": 120e-9, "build": 230e-9,
        "read.build_overflow": 50e-9, "query": 130e-9, "graph.replay": 80e-9,
        "shard": 180e-9})
    assert sum(by.values()) == pytest.approx(1000e-9 - st.busy_s(1))
    # card 0: busy [40, 240], [340, 420], [955, 965]
    by0 = st.idle_by_span(0)
    assert by0["build"] == pytest.approx(30e-9)
    assert by0["graph.replay"] == pytest.approx(20e-9)
    assert sum(by0.values()) == pytest.approx(1e-6 - 290e-9)


def test_no_spans_no_call():
    """A program without spans (the parent of the span metrics): no extra
    call, every span metric left out."""
    raw = [Ev(trace.WINDOW, 0, 1000, note=True)] + _work()
    run = SimpleNamespace(trace=trace.Trace(raw, [0, 1]))
    assert not spans.has_spans(run.trace)
    assert spans.of(run) is None
    for name in ("build_span_ms.step", "query_span_ms.step",
                 "replay_copy_ms.evals", "build_wait_pct.weak4",
                 "issue_lag_ms.weak4"):
        assert harness.load_reader(name)(run) is None


def test_the_span_readers(st):
    said = []
    mesh = SimpleNamespace(devices=[SimpleNamespace(index=0),
                                    SimpleNamespace(index=1)])
    run = SimpleNamespace(trace=None, _span_trace=st,
                          entry=SimpleNamespace(mesh=mesh),
                          say=lambda **kw: said.append(kw))
    read = {name: harness.load_reader(name)(run) for name in (
        "build_span_ms.step", "query_span_ms.step", "replay_copy_ms.evals",
        "build_wait_pct.weak4", "issue_lag_ms.weak4")}
    assert read == pytest.approx({
        "build_span_ms.step": 200e-6, "query_span_ms.step": 180e-6,
        "replay_copy_ms.evals": 20e-6,
        # card 1 alone (the mesh's first card is card 0): 280 of 1000 ns
        "build_wait_pct.weak4": 28.0,
        # card 1's first operation of its first shard: 500 - 420 ns
        "issue_lag_ms.weak4": 80e-6})
    assert said == [{"issue_lag_ms_by_card": {1: pytest.approx(80e-6)}}]


def _window(with_program: bool):
    raw = [Ev(trace.WINDOW, 0, 1000, note=True)] + _work()
    if with_program:
        raw += _spans() + _device_notes()
    return trace.Trace(raw, [0, 1])


@pytest.mark.parametrize("read", [
    lambda t: [t.busy_s(0), t.busy_s(1), t.mean_busy_s()],
    lambda t: [t.idle_pct(), t.idle_pct(0), t.idle_pct(1)],
    lambda t: t.op_seconds(lambda n: "graph" in n),
    lambda t: t.top_ops(),
    lambda t: [d for _, d in t.idle_gaps()],
], ids=["busy_s", "idle_pct", "op_seconds", "top_ops", "idle_gap_seconds"])
def test_the_window_reads_the_same_with_the_programs_spans(read):
    assert read(_window(True)) == read(_window(False))


def test_a_gap_with_no_runtime_call_is_named_by_its_span():
    """Card 1's gap [600, 1000] has its middle at 800, the end of the
    query span with no runtime call in progress: the host event there."""
    names = dict(_window(True).idle_gaps())
    assert "cuda:1 rakau.query" in names
    assert "cuda:1 host" in dict(_window(False).idle_gaps())
