"""rakau_tpu_torch's spans (utils/timing.py) on the CPU: with no profiler
`span` is one shared null context and nothing is recorded; under
torch.profiler a Tree query, a leapfrog step and a sharded call each
record their `rakau.*` spans with their nesting and today's count of host
reads (3 a query, 5 a step, 2 a sharded call); the LET's stages are spans
and stage_seconds() still times them; no span opens inside a capture."""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rakau_tpu_torch import integrate, octree
from rakau_tpu_torch.config import TreeConfig
from rakau_tpu_torch.parallel import let, sharded
from rakau_tpu_torch.utils import timing

torch.set_num_threads(1)

N = 2048
CFG = TreeConfig(max_depth=8, max_leaf_n=16, ncrit=64, tile_chunk=8)


def _cloud(n: int = N):
    rng = np.random.default_rng(5)
    pos = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32)
    return pos, torch.full((n,), 1.0 / n)


def _paths(prof) -> Counter:
    """Each `rakau.*` span as the path of span names from its outermost
    enclosing span down to it (prefix dropped), counted."""
    ev = sorted(((e.start_ns(), -(e.start_ns() + e.duration_ns()),
                  e.name()[len(timing.PREFIX):])
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(timing.PREFIX)))
    out, stack = Counter(), []
    for start, neg_end, name in ev:
        while stack and stack[-1][0] < start:
            stack.pop()
        out["/".join([s[1] for s in stack] + [name])] += 1
        stack.append((-neg_end, name))
    return out


def _profiled(fn) -> Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _paths(prof)


def _reads(paths: Counter) -> int:
    return sum(c for p, c in paths.items()
               if p.rsplit("/", 1)[-1].startswith("read."))


def test_no_profiler_no_span():
    assert timing.span("build") is timing.span("query")
    pos, mass = _cloud()
    t = octree(coords=pos, masses=mass, device="cpu", config=CFG)
    t.accs_pots_o(0.5)
    assert _profiled(lambda: None) == Counter()


def test_no_span_inside_a_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timing.span("slice") is timing.span("tail")
        with timing.span("slice"):
            pass
    assert _paths(prof) == Counter()


def test_read_is_the_host_copy_under_its_span():
    x = torch.arange(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = timing.read(x, "n_tiles")
    assert torch.equal(y, x)
    assert _paths(prof) == Counter({"read.n_tiles": 1})


def test_a_tree_query():
    pos, mass = _cloud()
    t = octree(coords=pos, masses=mass, device="cpu", config=CFG)
    paths = _profiled(lambda: t.accs_pots_o(0.5))
    assert set(paths) == {
        "query", "query/query_state", "query/read.n_tiles", "query/slice",
        "query/tail", "read.query_overflow", "read.query_maxima", "reorder"}
    assert _reads(paths) == 3


UPDATES = {
    "update_positions_u": lambda t: t.positions_u * 0.99,
    "update_positions_o": lambda t: t.positions_o * 0.99,
    "update_masses_u": lambda t: t.masses_u * 2,
    "update_masses_o": lambda t: t.masses_o * 2}


@pytest.mark.parametrize("method", sorted(UPDATES))
def test_a_tree_update(method):
    pos, mass = _cloud()
    t = octree(coords=pos, masses=mass, device="cpu", config=CFG)
    new = UPDATES[method](t)
    paths = _profiled(lambda: getattr(t, method)(new))
    assert paths == Counter({"update": 1, "update/read.valid": 1,
                             "update/build": 1,
                             "update/build/read.build_overflow": 1})
    assert _reads(paths) == 2


def test_a_leapfrog_step():
    pos, mass = _cloud()
    state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
    paths = _profiled(lambda: integrate.leapfrog_step_morton_host_safe(
        state, 1e-3, CFG, 0.5, 0.01))
    q = "step/step/query"
    assert paths == Counter({
        "step": 1, "step/step": 1, "step/step/build": 2,
        "step/step/build/read.build_overflow": 2, q: 2,
        q + "/query_state": 2, q + "/read.n_tiles": 2,
        q + "/slice": paths[q + "/slice"], q + "/tail": 2,
        "step/read.step_overflow": 1})
    assert paths[q + "/slice"] >= 2
    assert _reads(paths) == 5


def test_a_sharded_call():
    pos, mass = _cloud()
    mesh = sharded.default_mesh(2, device="cpu")
    paths = _profiled(lambda: sharded.acc_pot_sharded_host(
        pos, mass, CFG, 0.5, 0.01, 1.0, mesh))
    assert paths == Counter({
        "build": 1, "build/read.build_overflow": 1, "query": 1,
        "query/query_state": 1, "query/mesh.to_shards": 3,
        "query/read.n_tiles": 1, "query/shard": 2,
        "query/shard/slice": paths["query/shard/slice"],
        "query/mesh.any": 1, "query/tail": 1,
        "query/tail/mesh.gather_cat": 2, "reorder": 1})
    assert paths["query/shard/slice"] >= 2
    assert _reads(paths) == 2


def test_the_let_stages_are_spans_and_still_timed():
    pos, mass = _cloud(512)
    mesh = sharded.default_mesh(2, device="cpu")
    stages = {"phase0", "local_build", "export_walk", "exchange",
              "local_query", "return_route"}
    with let.stage_seconds() as seconds:
        paths = _profiled(lambda: let.acc_pot_let_host(
            pos, mass, CFG, 0.5, 0.01, 1.0, mesh, export_cap=1024,
            export_node_cap=512, export_part_cap=2048, export_leaf_cap=256,
            export_frontier_cap=256))
    assert set(seconds) == stages
    assert {p.split("/")[0] for p in paths if p.startswith("let.")} \
        == {"let." + s for s in stages}
    assert paths["let.local_query/query"] == 2
