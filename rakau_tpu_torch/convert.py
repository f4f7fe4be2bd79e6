"""Carry state across from the JAX package: the config, a built tree,
the gwalk incidence lists and an integration state.

For an N-body engine the "parameters" are the configuration and the
tree. These helpers take the JAX objects' plain data (a dataclass, numpy
arrays) and never import JAX, so one JAX-built tree can feed both
engines and traversal and query can be compared apart from the build
(and the gwalk pool apart from the walk).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .build import TreeData
from .config import TreeConfig
from .integrate import NBodyState
from .traversal4 import GlobalLists


def _tensor(v, device) -> torch.Tensor:
    """numpy array -> tensor on device; integers become int64."""
    v = np.asarray(v)
    if v.dtype.kind in "iu":
        v = v.astype(np.int64)
    return torch.from_numpy(np.array(v)).to(device)


def config_from_jax(cfg) -> TreeConfig:
    """`rakau_tpu.config.TreeConfig` -> this package's TreeConfig (the
    fields are the same)."""
    return TreeConfig(**dataclasses.asdict(cfg))


def treedata_from_numpy(arrays: dict, device) -> TreeData:
    """JAX `TreeData` fields as numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in td._asdict().items()}`) -> TreeData on
    `device`. The (code_hi, code_lo) uint32 pair becomes one int64 code;
    integer arrays become int64; floats keep their dtype."""
    hi = np.asarray(arrays["code_hi"]).astype(np.int64)
    lo = np.asarray(arrays["code_lo"]).astype(np.int64)
    fields = {"code": (hi << 32) | lo}
    for name in TreeData._fields:
        if name != "code":
            fields[name] = arrays[name]
    return TreeData(**{k: _tensor(v, device) for k, v in fields.items()})


def global_lists_from_numpy(arrays: dict, device) -> GlobalLists:
    """JAX `traversal4.GlobalLists` fields as numpy arrays (e.g.
    `{k: np.asarray(v) for k, v in gl._asdict().items()}`) ->
    traversal4.GlobalLists on `device`, integer arrays as int64."""
    return GlobalLists(**{k: _tensor(arrays[k], device)
                          for k in GlobalLists._fields})


def nbody_state_from_numpy(pos, vel, mass, device):
    """(pos [N, D], vel [N, D], mass [N]) numpy arrays, e.g. the fields of a
    JAX `NBodyState` -> `integrate.NBodyState` on `device`, dtypes kept."""
    return NBodyState(*(torch.from_numpy(np.array(a)).to(device)
                        for a in (pos, vel, mass)))
