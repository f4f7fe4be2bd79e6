"""The collective layer of the multi-device paths: one controller driving
several devices. Counterpart of `jax.sharding.Mesh` plus `shard_map` as
`rakau_tpu.parallel` uses them.

A `Mesh` is a tuple of devices, one per shard; several shards may share
a device (a card). A pipeline alternates per-shard stages (a function of
one shard's tensors, which live on its device) with the collectives
below. A collective takes a list of per-shard tensors, xs[r] on shard r's
device, and returns a list of the same kind: each piece is moved to its
destination shard's device (`Tensor.to`, no copy when the shards share a
device).

A copy between two cards is ordered on the cards, never on the host:
PyTorch issues it on the source card's current stream after that stream
waits for the destination's, and the destination's current stream waits
for the copy (events, no `torch.cuda.synchronize`). It goes peer to peer
where `torch.cuda.can_device_access_peer` allows it, else through the
CUDA driver's own path. `copied` keeps the bytes the collectives moved
between devices, and each call of a collective is the span
`mesh.<its name>` (utils.timing).

The stages: `stage_map` runs a per-shard function over every shard and
`on_first` a function on the first shard's device, in one of three ways
(`staged`):
  * None, the one-call form: a Python loop where the caller runs, which on
    a one-card mesh is inside the one CUDA graph of a whole call (or
    eager around it);
  * True: the shards of each card together as one call (`_each`) on that
    card, replayed from its own CUDA graph (one graph cannot span cards);
    the cards are issued one after another without waiting, so they run
    at the same time;
  * False: the same stages run eagerly, each under its card's device.
The collectives always run between the stages, outside every graph.

No multi-process back end and no NCCL: the reference is single-controller
too.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext
from typing import NamedTuple, Optional

import torch

from .. import engine
from ..utils.timing import span


class Mesh(NamedTuple):
    """One device per shard, in shard order."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def default_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A mesh of `n_devices` shards (default: one per card). With no
    `device`, shard r sits on cuda:(r % card count), so several shards may
    share a card; with no card this raises RuntimeError. device="cpu" (or
    any one device) puts every shard there, as the tests do."""
    if device is not None:
        dev = torch.device(device)
        return Mesh((dev,) * (1 if n_devices is None else n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError("default_mesh: no CUDA card; pass device='cpu' "
                           "to run the shards on the CPU")
    cards_ = torch.cuda.device_count()
    n = cards_ if n_devices is None else n_devices
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(tuple(torch.device("cuda", r % cards_) for r in range(n)))


def cards(mesh: Mesh) -> list:
    """[(device, shard indices on it)]: the mesh's shards grouped by
    device, the devices in the order of their first shard, each group in
    shard order."""
    groups: dict = {}
    for r, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(r)
    return [(dev, tuple(rs)) for dev, rs in groups.items()]


def one_card(mesh: Mesh) -> bool:
    """Whether every shard sits on one device, so that a whole call can
    be one CUDA graph."""
    return len(set(mesh.devices)) == 1


# ---------------------------------------------------------------- stages
def _each(fn, args: tuple) -> tuple:
    """fn(*a) for each a in args, in order: one card's shards."""
    return tuple(fn(*a) for a in args)


def _on(dev):
    """Device context of a stage on `dev` (a CPU device needs none)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _stage(dev, graph: bool, fn, *args):
    with _on(dev):
        return engine._run(graph, fn, *args)


def stage_map(mesh: Mesh, fn, args: list, staged=None) -> list:
    """[fn(*args[r]) for every shard r], args[r] on shard r's device, in
    the way `staged` names (the module's docstring). With staged True each
    card's call is a CUDA graph: one that fails to capture raises."""
    if staged is None:
        return [fn(*a) for a in args]
    out = [None] * mesh.size
    for dev, shards in cards(mesh):
        res = _stage(dev, staged, _each, fn, tuple(args[r] for r in shards))
        for r, o in zip(shards, res):
            out[r] = o
    return out


def on_first(mesh: Mesh, fn, staged, *args):
    """fn(*args) on the first shard's device, in the way `staged` names."""
    if staged is None:
        return fn(*args)
    return _stage(mesh.devices[0], staged, fn, *args)


# ----------------------------------------------------------- collectives
# bytes the collectives copied, by (source device, destination device)
copied: dict = {}


def reset_copied():
    copied.clear()


def _move(x: torch.Tensor, dev) -> torch.Tensor:
    y = x.to(dev)
    if y is not x:
        k = (str(x.device), str(y.device))
        copied[k] = copied.get(k, 0) + x.nbytes
    return y


def _collective(fn):
    """fn under the span `mesh.<fn's name>`."""
    name = "mesh." + fn.__name__

    @functools.wraps(fn)
    def call(*args, **kw):
        with span(name):
            return fn(*args, **kw)

    return call


def _to(x, dev):
    """x (a tensor, or a tuple or named tuple of them) on dev."""
    if isinstance(x, torch.Tensor):
        return _move(x, dev)
    if isinstance(x, tuple):
        items = [_to(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@_collective
def all_to_all(xs: list) -> list:
    """xs[s]: [ndev, ...] on shard s. out[r] = stack over s of xs[s][r],
    on shard r's device (jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False))."""
    return [torch.stack([_move(x[r], xs[r].device) for x in xs])
            for r in range(len(xs))]


@_collective
def all_gather(xs: list) -> list:
    """out[r] = stack over s of xs[s], on shard r's device."""
    return [torch.stack([_move(x, dst.device) for x in xs]) for dst in xs]


@_collective
def pmax(xs: list) -> list:
    """Elementwise maximum over the shards, on every shard."""
    return [torch.stack([_move(x, dst.device) for x in xs]).amax(0)
            for dst in xs]


@_collective
def any(xs: list) -> list:  # noqa: A001 (the collective's name)
    """Elementwise logical OR over the shards (bool), on every shard."""
    return [torch.stack([_move(x, dst.device).bool() for x in xs]).any(0)
            for dst in xs]


@_collective
def gather(xs: list, dev) -> list:
    """Each shard's piece (a tensor, or a tuple of them) on `dev`, in shard
    order."""
    return [_to(x, dev) for x in xs]


@_collective
def gather_cat(xs: list, dev) -> torch.Tensor:
    """The shards' pieces concatenated along their first axis on `dev`,
    each moved there and put in its place in one buffer as it comes: the
    moved pieces are not all held beside the result (at 2^26 particles
    the tiles' sums are 2.1 GB)."""
    out = xs[0].new_empty((sum(x.shape[0] for x in xs),) + xs[0].shape[1:],
                          device=dev)
    off = 0
    for x in xs:
        out[off:off + x.shape[0]] = _move(x, dev)
        off += x.shape[0]
    return out


@_collective
def scatter(mesh: Mesh, xs: list) -> list:
    """xs[r] (a tensor, or a tuple of them) on shard r's device."""
    return [_to(x, dev) for x, dev in zip(xs, mesh.devices)]


@_collective
def to_shards(mesh: Mesh, x) -> list:
    """The same tensor (or NamedTuple of tensors) on every shard's device:
    one copy per distinct device."""
    out, seen = [], {}
    for dev in mesh.devices:
        if dev not in seen:
            seen[dev] = _to(x, dev)
        out.append(seen[dev])
    return out


def synchronize(mesh: Mesh):
    """Wait for every card of the mesh (a no-op on the CPU)."""
    for dev, _ in cards(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


__all__ = ["Mesh", "default_mesh", "cards", "one_card", "stage_map",
           "on_first", "all_to_all", "all_gather", "pmax", "any", "gather",
           "gather_cat", "scatter", "to_shards", "copied", "reset_copied",
           "synchronize"]
