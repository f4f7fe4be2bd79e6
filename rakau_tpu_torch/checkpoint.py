"""Save and restore a tree or an integration state as `.npz` files.
Counterpart of `rakau_tpu.checkpoint`, with the same file layout, so that
files written by either package load in the other.

A tree is saved as its user-order positions and masses, box size and
config (as JSON), and rebuilt on load."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .config import TreeConfig
from .tree import Tree


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_tree(path: str, tree: Tree) -> None:
    cfg = dataclasses.asdict(tree.config)
    np.savez_compressed(
        path,
        positions=_np(tree.positions_o),
        masses=_np(tree.masses_o),
        box_size=np.asarray(tree.box_size),
        config_json=np.asarray(json.dumps(cfg)),
    )


def load_tree(path: str, device=None) -> Tree:
    """Rebuild a saved tree on `device` (the CUDA card when None)."""
    with np.load(path, allow_pickle=False) as z:
        cfg = json.loads(str(z["config_json"]))
        # JSON turns the one tuple field (gwalk_round_caps) into a list
        if cfg.get("gwalk_round_caps") is not None:
            cfg["gwalk_round_caps"] = tuple(cfg["gwalk_round_caps"])
        return Tree(coords=z["positions"], masses=z["masses"],
                    box_size=float(z["box_size"]),
                    config=TreeConfig(**cfg), device=device)


def save_state(path: str, pos, vel, mass, **extra) -> None:
    """Save an integration state (positions, velocities, masses and any
    named scalars or arrays)."""
    np.savez_compressed(path, positions=_np(pos), velocities=_np(vel),
                        masses=_np(mass),
                        **{k: _np(v) for k, v in extra.items()})


def load_state(path: str) -> dict:
    """The saved arrays by name, as numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
