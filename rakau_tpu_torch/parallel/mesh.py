"""The collective layer of the multi-device paths: one controller driving
several devices. Counterpart of `jax.sharding.Mesh` plus `shard_map` as
`rakau_tpu.parallel` uses them.

A `Mesh` is a tuple of devices, one per shard. A pipeline is a Python
loop over the shards for each per-shard stage (a plain function of that
shard's tensors, which live on its device), alternating with the
collectives below. A collective takes a list of per-shard tensors, xs[r]
on shard r's device, and returns a list of the same kind: each piece is
moved to its destination shard's device (`Tensor.to`, no copy when the
shards share a device). CUDA launches are asynchronous, so the stages of
shards on different cards overlap until something reads a device value
on the host; the places that do say so (e.g. `engine.live_chunks`' read
of n_tiles in each shard's chunk loop).

No multi-process back end: the reference is single-controller too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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
    cards = torch.cuda.device_count()
    n = cards if n_devices is None else n_devices
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(tuple(torch.device("cuda", r % cards) for r in range(n)))


def one_card(graph: bool, mesh: Mesh) -> bool:
    """graph (whether a whole call replays a CUDA graph), refused where the
    mesh's shards sit on more than one device: a graph lives on one
    card."""
    devices = set(mesh.devices)
    if graph and len(devices) > 1:
        raise ValueError(
            f"one CUDA graph cannot span the mesh's devices "
            f"{sorted(map(str, devices))}: pass graph=False to run the "
            "whole call eagerly, or call its _host twin")
    return graph


def all_to_all(xs: list) -> list:
    """xs[s]: [ndev, ...] on shard s. out[r] = stack over s of xs[s][r],
    on shard r's device (jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=False))."""
    return [torch.stack([x[r].to(xs[r].device) for x in xs])
            for r in range(len(xs))]


def all_gather(xs: list) -> list:
    """out[r] = stack over s of xs[s], on shard r's device."""
    return [torch.stack([x.to(dst.device) for x in xs]) for dst in xs]


def pmax(xs: list) -> list:
    """Elementwise maximum over the shards, on every shard."""
    return [torch.stack([x.to(dst.device) for x in xs]).amax(0)
            for dst in xs]


def any(xs: list) -> list:  # noqa: A001 (the collective's name)
    """Elementwise logical OR over the shards (bool), on every shard."""
    return [torch.stack([x.to(dst.device).bool() for x in xs]).any(0)
            for dst in xs]


def to_shards(mesh: Mesh, x) -> list:
    """The same tensor (or NamedTuple of tensors) on every shard's device:
    one copy per distinct device."""
    out, seen = [], {}
    for dev in mesh.devices:
        if dev not in seen:
            seen[dev] = _to(x, dev)
        out.append(seen[dev])
    return out


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [_to(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def synchronize(mesh: Mesh):
    """Wait for every card of the mesh (a no-op on the CPU)."""
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


__all__ = ["Mesh", "default_mesh", "all_to_all", "all_gather", "pmax", "any",
           "to_shards", "synchronize"]
