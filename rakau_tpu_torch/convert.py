"""Carry state across from the JAX package: the config, a built tree,
the gwalk incidence lists, the lmac tables and an integration state.

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
from .traversal3 import GroupCand, LmacTables
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


def _split_lm(lm: np.ndarray, ndim: int, device):
    """The reference's packed lmac node rows [K, 3D+6(+Q)] (floats, with
    level + 64 * leaf flag, parent level and packed cell stored as
    floats) -> the port's (ff [K, 3D+3(+Q)] float, fi [K, 4] int64)."""
    D = ndim
    lm = np.asarray(lm)
    lvl_leaf = lm[:, 2 * D + 1].astype(np.int64)
    fi = np.stack([lvl_leaf & 63, (lvl_leaf >= 64).astype(np.int64),
                   lm[:, 2 * D + 2].astype(np.int64),
                   lm[:, 2 * D + 5].astype(np.int64)], axis=1)
    ff = np.concatenate([lm[:, :2 * D + 1], lm[:, 2 * D + 3:2 * D + 5],
                         lm[:, 2 * D + 6:]], axis=1)
    return _tensor(ff, device), _tensor(fi, device)


def lmac_tables_from_numpy(lm, pm, ndim: int, L0: int, device) -> LmacTables:
    """The fields of a JAX `traversal3.LmacTables` (lm, pm as numpy
    arrays, ndim, L0) -> traversal3.LmacTables on `device`."""
    ff, fi = _split_lm(lm, ndim, device)
    return LmacTables(ff=ff, fi=fi, pm=_tensor(pm, device), L0=int(L0))


def group_cand_from_numpy(lm, begin, end, overflow, count, ndim: int,
                          device) -> GroupCand:
    """The fields of a JAX `traversal3.GroupCand` as numpy arrays ->
    traversal3.GroupCand on `device`."""
    ff, fi = _split_lm(lm, ndim, device)
    return GroupCand(ff=ff, fi=fi, begin=_tensor(begin, device),
                     end=_tensor(end, device),
                     overflow=_tensor(np.asarray(overflow, bool), device),
                     count=_tensor(np.asarray(count), device))


def nbody_state_from_numpy(pos, vel, mass, device):
    """(pos [N, D], vel [N, D], mass [N]) numpy arrays, e.g. the fields of a
    JAX `NBodyState` -> `integrate.NBodyState` on `device`, dtypes kept."""
    return NBodyState(*(torch.from_numpy(np.array(a)).to(device)
                        for a in (pos, vel, mass)))
