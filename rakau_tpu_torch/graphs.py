"""CUDA graphs: the port's counterpart of `jax.jit` on the card.

The reference runs each piece of a query (a slice of chunks, the gwalk
walk and pool, the assembly, the whole `acc_pot_u`), the tree build and
each whole integrate call (a build and its query, a leapfrog step, an
energy) as one compiled XLA executable. Here the same piece runs eagerly
once, is captured into a `torch.cuda.CUDAGraph`, and every later call
with the same key replays that graph: its thousands of small launches
leave the host as one.

`GraphCache` keeps the captured graphs. A call's key is the function, the
structure of its arguments with every non-tensor leaf in it (the
`TreeConfig`, `mode`, a numeric box size, the functions a whole call
is given), the shape, dtype and device of every tensor leaf, and
the caller's `key` (global switches the function reads). theta, eps and G
reach a graph as 0-dim tensors (`engine.scalars`), as the reference
traces them: their values are inputs, so a new one replays. The first call
with a key
  * runs the function eagerly once on a side stream (as the
    `torch.cuda.graphs` documentation requires before a capture): this
    builds the kernel libraries, fills the occupancy statics of `csrc/`
    and the constant tables (`device_constant`), and warms the allocator;
  * hands the allocator's cached free blocks back to the card where they
    exceed what the card has free (_hand_back_cache): a capture cannot;
  * captures it into a graph that draws on the cache's memory pool for
    its device (the graphs of a device never run at the same time, and
    each call clones its outputs before any other replay can reuse their
    memory);
  * keeps the static input buffers, cloned from that call's tensors; a
    tensor that an earlier live graph of the cache was captured on gets
    that graph's buffer (a query's slices and its tail, both captured on
    the tree, hold one copy of it, not two: 4.9 GB at 64M particles).
Every call copies its tensors into the static inputs, replays the graph
and returns clones of the outputs: fresh tensors, as a jitted call's are.
A replay is the span `graph.replay` and a first call's warm-up and capture
the span `graph.capture` (utils.timing), so that a profile puts the
copies and clones apart from the graph's own launch.
A shared buffer is always filled with the caller's data before the
replay that reads it: graphs replay one at a time on a device.

The kernel wrappers count their launches in plain dicts (`launches` of
`kernels.shared`, `kernels.pool`, `kernels.tiles`), where they launch and
nowhere else: the warm-up's launches and the ones a capture records into
its graph count there, a replay adds nothing. The cache keeps its own
tally beside them: how much each count grew during each capture
(`captured`) and, for every replay, the same amounts again (`replayed`),
so that wrapper counts - captured + replayed is what a call's kernels
ran. It is bookkeeping, to hold against what a profiler of the card
counts; it measures nothing.

A capture or replay that fails raises; nothing falls back to the eager
path. CPU tensors have no graph: `ValueError`.

Tensors that the captured code reads must be static inputs or constants
made before the capture. `device_constant` keeps such constants (tables
built from NumPy) per key on their device; it refuses to build one while
a capture is running, where its host-to-device copy would either fail or
be baked into the graph.
"""
from __future__ import annotations

import functools
import time
import weakref

import torch

from .utils.timing import span

# What a key holds for a tensor leaf; any other leaf must be hashable.
_TENSOR = object()
# Captured graphs a cache keeps a device (a graph and its key belong to
# the device of its tensors, so one captured on one card never serves
# another); the one used least recently there is dropped first, because
# a graph pins its static inputs and outputs (a slice: a
# copy of the tree, its tables and tile panels, 0.1-0.3 GB at 1M
# particles; a build or a whole step: the particles and the tree, ~0.1
# GB) and its share of the pool. A host-sliced leapfrog step holds three
# (its build, slice and tail), its energy query three more (another cfg),
# the whole-call step and energy one each, a Tree's rebuild one: nine, so
# that a steady-state step, energy query or rebuild captures nothing even
# beside a whole-query `acc_pot_u`, a gwalk query and a kernel variant's.
# A staged multi-card LET keeps nine on the first shard's card and seven
# on each other card (parallel/mesh.py).
SIZE = 16


def _flatten(x, tensors: list):
    """x as a hashable template in which every tensor leaf is
    (_TENSOR, its index in `tensors`), appended there. Tuples, named
    tuples, lists and dicts are walked; other leaves are kept with their
    type (so that 1, 1.0 and True are three keys)."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (_TENSOR, len(tensors) - 1)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, tensors) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, tensors)) for k, v in x.items()))
    hash(x)
    return (None, type(x), x)


def _build(template, tensors):
    """The inverse of _flatten, with `tensors` at the tensor leaves."""
    kind = template[0]
    if kind is _TENSOR:
        return tensors[template[1]]
    if kind is None:
        return template[2]
    if kind is dict:
        return {k: _build(v, tensors) for k, v in template[1]}
    items = [_build(v, tensors) for v in template[1]]
    if hasattr(kind, "_fields"):
        return kind(*items)
    return kind(items)


def _meta(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, t.device)


def _add(tally: list, counts: list):
    for t, c in zip(tally, counts):
        for k, v in c.items():
            t[k] = t.get(k, 0) + v


class _Graph:
    """One captured call: the graph, its static inputs and outputs, and
    the launches its capture recorded (one dict per counter)."""

    def __init__(self, graph, inputs, out_template, outputs, counts):
        self.graph = graph
        self.inputs = inputs
        self.out_template = out_template
        self.outputs = outputs
        self.counts = counts

    def replay(self, tensors):
        with span("graph.replay"):
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
            self.graph.replay()
            return _build(self.out_template,
                          [o.clone() for o in self.outputs])


class GraphCache:
    """Captured CUDA graphs by key, at most SIZE of them a device.
    `counters`: the
    launch-count dicts whose growth at capture the tally keeps (see the
    module's docstring): `captured` and `replayed`, one dict per counter,
    and `captures`, the graphs captured, and `capture_s`, the host
    seconds of the first calls (warm-up and capture) by device, set to
    zero by reset_tally()."""

    def __init__(self, counters=()):
        self.counters = tuple(counters)
        self._graphs: dict = {}
        self._pools: dict = {}
        # static input buffers of the live graphs, by the tensor they were
        # cloned from (device, address, shape, strides, dtype)
        self._statics = weakref.WeakValueDictionary()
        self.reset_tally()

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        """Drop every graph and the pools' handles: their memory returns
        to the allocator's cache (torch.cuda.empty_cache() hands it back
        to the card)."""
        self._graphs.clear()
        self._pools.clear()

    def reset_tally(self):
        self.captured = [{} for _ in self.counters]
        self.replayed = [{} for _ in self.counters]
        self.captures = 0
        self.capture_s: dict = {}

    def pinned(self) -> list:
        """(function name, bytes of its static inputs and outputs) of each
        graph, least recently used first (a static input that graphs share
        counts in each); the pool comes on top."""
        return [(k[0].__name__, sum(t.nbytes for t in g.inputs + g.outputs))
                for k, g in self._graphs.items()]

    def key(self, fn, args, kwargs, key=()):
        """The cache key of fn(*args, **kwargs) (see the module's
        docstring) and the tensor leaves, in order."""
        tensors: list = []
        template = _flatten((args, kwargs), tensors)
        return ((fn, template, tuple(_meta(t) for t in tensors), key),
                tensors)

    def __call__(self, fn, *args, key=(), **kwargs):
        """fn(*args, **kwargs) replayed from its graph (captured at the
        first call with this key). Every tensor argument must lie on one
        CUDA device."""
        k, tensors = self.key(fn, args, kwargs, key)
        if not tensors or any(not t.is_cuda for t in tensors):
            raise ValueError("CUDA graphs take CUDA tensors only; the CPU "
                             "runs eagerly (graph=False)")
        dev = tensors[0].device
        if any(t.device != dev for t in tensors):
            raise ValueError("a captured call takes tensors on one device")
        with torch.cuda.device(dev):
            g = self._graphs.pop(k, None)
            if g is None:
                with span("graph.capture"):
                    g = self._capture(fn, k[1], tensors, dev)
            self._keep(k, g)
            out = g.replay(tensors)
            _add(self.replayed, g.counts)
            return out

    def _keep(self, k, g):
        """g under key k as the most recently used graph (last), the least
        recently used ones of its device (the key's tensors') dropped
        while that device holds SIZE."""
        dev = k[2][0][2]
        mine = [kk for kk in self._graphs if kk[2][0][2] == dev]
        for kk in mine[:max(0, len(mine) - SIZE + 1)]:
            del self._graphs[kk]
        self._graphs[k] = g

    def _snapshot(self):
        return [dict(c) for c in self.counters]

    def _static(self, t: torch.Tensor) -> torch.Tensor:
        """The static input buffer for the caller's tensor t, holding t's
        data: a live graph's, where one was captured on a tensor at t's
        address with its layout (filled with t, which may be another
        tensor since), else a new clone."""
        k = (t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
        s = self._statics.get(k)
        if s is None:
            s = self._statics[k] = t.clone()
        else:
            s.copy_(t)
        return s

    def _capture(self, fn, template, tensors, dev) -> _Graph:
        t0 = time.perf_counter()
        inputs = [self._static(t) for t in tensors]
        args, kwargs = _build(template, inputs)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args, **kwargs)
        torch.cuda.current_stream(dev).wait_stream(side)
        _hand_back_cache(dev)
        if dev not in self._pools:
            self._pools[dev] = torch.cuda.graph_pool_handle()
        before = self._snapshot()
        graph = torch.cuda.CUDAGraph()
        # captured on a stream of dev: torch.cuda.graph's own default
        # capture stream is made once, on the device current at its first
        # use, and a capture on another card would record into it
        with torch.cuda.graph(graph, pool=self._pools[dev], stream=side):
            out = fn(*args, **kwargs)
        counts = [{f: c[f] - was[f] for f in c if c[f] != was[f]}
                  for c, was in zip(self.counters, before)]
        _add(self.captured, counts)
        self.captures += 1
        self.capture_s[str(dev)] = (self.capture_s.get(str(dev), 0.0)
                                    + time.perf_counter() - t0)
        outputs: list = []
        out_template = _flatten(out, outputs)
        return _Graph(graph, inputs, out_template, outputs, counts)


def _hand_back_cache(dev):
    """Return the allocator's cached free blocks to the card when they
    hold more than the card has free, between a warm-up and its capture.
    A capture draws on the graph pool, and while it runs the allocator
    cannot free cached blocks to make room (outside a capture it does so
    before it fails): the warm-up has just left its peak there. At 64M
    particles a query's capture ran out of memory so, beside a live build
    graph, with most of the card's memory cached and unused."""
    free, _ = torch.cuda.mem_get_info(dev)
    cached = (torch.cuda.memory_reserved(dev)
              - torch.cuda.memory_allocated(dev))
    if cached > free:
        torch.cuda.empty_cache()


def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def device_constant(fn):
    """Decorator for a function of hashable arguments (its device among
    them) that builds constant tensors, e.g. from NumPy tables: each
    result is built once per argument tuple and kept. A first build while
    a graph is being captured raises, so a table is always made by the
    eager run before a capture (GraphCache's warm-up), never inside it."""
    cache: dict = {}

    @functools.wraps(fn)
    def get(*args):
        hit = cache.get(args)
        if hit is None:
            if capturing():
                raise RuntimeError(
                    f"{fn.__name__}{args}: a constant table built inside a "
                    "CUDA graph capture (the warm-up run makes it first)")
            hit = cache[args] = fn(*args)
        return hit

    return get
