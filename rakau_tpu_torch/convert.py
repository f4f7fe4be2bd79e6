"""Carry state across from the JAX package: the config, a built tree and
an integration state.

For an N-body engine the "parameters" are the configuration and the
tree. These helpers take the JAX objects' plain data (a dataclass, numpy
arrays) and never import JAX, so one JAX-built tree can feed both
engines and traversal and query can be compared apart from the build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .build import TreeData
from .config import TreeConfig
from .integrate import NBodyState


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
            fields[name] = np.asarray(arrays[name])
    out = {}
    for name, v in fields.items():
        if v.dtype.kind in "iu":
            v = v.astype(np.int64)
        out[name] = torch.from_numpy(np.array(v)).to(device)
    return TreeData(**out)


def nbody_state_from_numpy(pos, vel, mass, device):
    """(pos [N, D], vel [N, D], mass [N]) numpy arrays, e.g. the fields of a
    JAX `NBodyState` -> `integrate.NBodyState` on `device`, dtypes kept."""
    return NBodyState(*(torch.from_numpy(np.array(a)).to(device)
                        for a in (pos, vel, mass)))
