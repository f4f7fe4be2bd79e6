"""User-facing Tree API. Counterpart of `rakau_tpu.tree`.

`octree` / `quadtree` are built from coordinate and mass arrays with the
reference's kwargs (box_size, max_leaf_n, ncrit, ..., and every other
TreeConfig field, the grid2 knobs local_order, grid_multipole_order,
grid_sep, grid_level and grid_occupancy among them), queried through
`accs_u/o`, `pots_u/o`, `accs_pots_u/o` with per-call theta/eps/G, and
updated through `update_positions_u/o` / `update_masses_u/o` with
permutation composition; `exact_*` are the direct-sum oracles.

Every tensor lives on the tree's `device`: the CUDA card unless the
caller passes `device="cpu"` (or another device), whatever the type of
the input. With no card and no device given, the constructor raises.
Interaction-list capacities are static; a query that overflows one
grows it and runs again, never truncates.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from . import direct as _direct
from . import engine as _engine
from . import particles as _particles
from .config import TreeConfig, fit_caps, grow_overflowed
from .utils.timing import read, span

ArrayLike = Union[torch.Tensor, np.ndarray]


def _as_tensor(x, dtype, device):
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _stack_coords(coords, x_coords, y_coords, z_coords, ndim, dtype,
                  device):
    if coords is not None:
        pos = _as_tensor(coords, dtype, device)
        if pos.ndim != 2 or pos.shape[1] != ndim:
            raise ValueError(
                f"coords must be [N, {ndim}], got {tuple(pos.shape)}")
        return pos.contiguous()
    comps = [x_coords, y_coords, z_coords][:ndim]
    if any(c is None for c in comps):
        raise ValueError(
            "provide either coords=[N, ndim] or all of "
            + "/".join(["x_coords", "y_coords", "z_coords"][:ndim]))
    return torch.stack([_as_tensor(c, dtype, device) for c in comps], dim=1)


def resolve_device(device) -> torch.device:
    """`device`, or the CUDA card when it is None. Raises when None is
    given and there is no card: the entry points never fall back to the
    CPU on their own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: rakau_tpu_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


class Tree:
    """Barnes-Hut tree over point masses (octree in 3D, quadtree in 2D)."""

    def __init__(self, coords=None, masses=None, *, x_coords=None,
                 y_coords=None, z_coords=None, box_size=None,
                 ndim: int = 3, dtype=None, device=None,
                 max_leaf_n: int = 64, ncrit: int = 256, mac: str = "bh",
                 multipole_order: int = 0,
                 config: Optional[TreeConfig] = None,
                 max_retries: int = 6, **cfg_kwargs):
        probe = coords if coords is not None else x_coords
        self._device = resolve_device(device)
        if config is not None:
            cfg = config
        else:
            if dtype is None:
                d = str(torch.as_tensor(probe).dtype).replace("torch.", "")
                dtype = d if d in ("float32", "float64") else "float32"
            dtype = str(dtype).replace("torch.", "")
            cfg = TreeConfig(ndim=ndim, dtype=dtype,
                             max_leaf_n=max_leaf_n, ncrit=ncrit, mac=mac,
                             multipole_order=multipole_order, **cfg_kwargs)
        self._cfg = cfg
        self._max_retries = max_retries
        tdt = cfg.torch_dtype
        pos = _stack_coords(coords, x_coords, y_coords, z_coords, cfg.ndim,
                            tdt, self._device)
        if masses is None:
            raise ValueError("masses is required")
        mass = _as_tensor(masses, tdt, self._device).contiguous()
        if box_size is None:
            box = _particles.auto_box_size(pos)
        else:
            box = torch.tensor(float(box_size), dtype=tdt,
                               device=self._device)
        _particles.raise_on_invalid(pos, mass, box)
        self._box = box
        # perm maps Morton slot -> ORIGINAL user index, composed across
        # updates; last_perm is the most recent re-sort only
        self._orig_perm = None
        self._last_perm = None
        self._last_stats = None
        self._rebuild(pos, mass)

    # ------------------------------------------------------------- build
    def _rebuild(self, pos, mass):
        """Full re-sort + rebuild (on the card replayed from the build's
        CUDA graph: engine.build_tree), growing node/tile capacities on
        overflow (read after the build)."""
        cfg = self._cfg
        n = pos.shape[0]
        for _ in range(self._max_retries):
            with span("build"):
                td = _engine.build_tree(pos, mass, cfg, self._box)
                overflow = bool(read(td.overflow, "build_overflow"))
            if not overflow:
                break
            cfg = cfg.with_(node_cap=2 * cfg.node_capacity(n),
                            tile_cap=2 * cfg.tile_capacity(n))
        else:
            raise RuntimeError("tree build overflow persisted after retries")
        self._cfg = cfg
        self._td = td
        self._last_perm = td.perm
        self._orig_perm = (td.perm if self._orig_perm is None
                           else self._orig_perm[td.perm])
        self._inv_orig = _inverse(self._orig_perm)

    # ------------------------------------------------------------ queries
    def _query(self, theta, eps, G, mode="both"):
        cfg = self._cfg
        if (cfg.traversal_mode == "lmac" and cfg.mac == "bh_geom"
                and float(theta) > 2.0 / cfg.ndim ** 0.5):
            # lmac's partition argument needs A(t, parent) => A(t, child);
            # with bh_geom's delta that holds for theta <= 2/sqrt(D)
            raise ValueError(
                f"traversal_mode='lmac' with mac='bh_geom' requires "
                f"theta <= {2.0 / cfg.ndim ** 0.5:.3f} "
                f"(monotonicity bound); got {float(theta)}")
        for _ in range(self._max_retries):
            acc, pot, ovf, mx = _engine.acc_pot_u_host(
                self._td, cfg, float(theta), float(eps), float(G), mode=mode)
            flags = read(ovf, "query_overflow").tolist()
            if not any(flags):
                self._last_stats = read(mx, "query_maxima").tolist()
                return acc, pot
            # grow every overflowed capacity (never truncate silently)
            cfg = grow_overflowed(cfg, flags)
            self._cfg = cfg
        raise RuntimeError(
            f"interaction-list overflow persisted after retries: {flags}")

    def tune_caps(self, slack: float = 1.25, quantum: int = 512):
        """Shrink the interaction-list capacities to the maxima measured
        by the most recent query (padded shapes cost kernel work)."""
        if self._last_stats is None:
            raise RuntimeError("run a query first")
        self._cfg = fit_caps(self._cfg, self._last_stats, slack=slack,
                             quantum=quantum)
        return self._cfg

    def accs_pots_u(self, theta, eps=0.0, G=1.0):
        """Accelerations and potentials, internal Morton order."""
        return self._query(theta, eps, G)

    def accs_pots_o(self, theta, eps=0.0, G=1.0):
        """Accelerations and potentials, original input order."""
        acc, pot = self._query(theta, eps, G)
        with span("reorder"):
            return acc[self._inv_orig], pot[self._inv_orig]

    def accs_u(self, theta, eps=0.0, G=1.0):
        """Accelerations only (the kernel skips the potential sums)."""
        return self._query(theta, eps, G, mode="acc")[0]

    def accs_o(self, theta, eps=0.0, G=1.0):
        return self.accs_u(theta, eps, G)[self._inv_orig]

    def pots_u(self, theta, eps=0.0, G=1.0):
        """Potentials only (the kernel skips the acceleration sums)."""
        return self._query(theta, eps, G, mode="pot")[1]

    def pots_o(self, theta, eps=0.0, G=1.0):
        return self.pots_u(theta, eps, G)[self._inv_orig]

    # ------------------------------------------------- exact (direct sum)
    def exact_accs_pots_u(self, eps=0.0, G=1.0):
        """O(N^2) direct-sum oracle, Morton order."""
        return _direct.direct_acc_pot(self._td.pos, self._td.mass,
                                      eps=eps, G=G)

    def exact_accs_pots_o(self, eps=0.0, G=1.0):
        acc, pot = self.exact_accs_pots_u(eps, G)
        return acc[self._inv_orig], pot[self._inv_orig]

    def exact_accs_u(self, eps=0.0, G=1.0):
        return self.exact_accs_pots_u(eps, G)[0]

    def exact_accs_o(self, eps=0.0, G=1.0):
        return self.exact_accs_pots_o(eps, G)[0]

    def exact_pots_u(self, eps=0.0, G=1.0):
        return self.exact_accs_pots_u(eps, G)[1]

    def exact_pots_o(self, eps=0.0, G=1.0):
        return self.exact_accs_pots_o(eps, G)[1]

    # ----------------------------------------------------------- updates
    def _update(self, new, which: str, ordered: bool):
        """Replace `which` ("pos" or "mass") by `new`, validate, re-sort
        and rebuild. `new` is a tensor in the input order where `ordered`,
        else in Morton order, or a callable applied to the current values
        in that order; either is checked against their shape."""
        with span("update"):
            cur = getattr(self._td, which)
            if callable(new):
                vals = new(cur[self._inv_orig] if ordered else cur)
            else:
                vals = _as_tensor(new, self._cfg.torch_dtype, self._device)
            if vals.shape != cur.shape:
                raise ValueError(f"shape {tuple(vals.shape)} != "
                                 f"{tuple(cur.shape)}")
            if ordered:
                vals = vals[self._orig_perm]
            pos, mass = ((vals, self._td.mass) if which == "pos"
                         else (self._td.pos, vals))
            _particles.raise_on_invalid(pos, mass, self._box)
            self._rebuild(pos, mass)

    def update_positions_u(self, new_positions: Union[Callable, ArrayLike]):
        """Replace positions (Morton order, or a callable applied to the
        Morton-order positions), then re-sort and rebuild, composing
        permutations so `_o` views keep the original input order."""
        self._update(new_positions, "pos", ordered=False)

    def update_positions_o(self, new_positions: Union[Callable, ArrayLike]):
        self._update(new_positions, "pos", ordered=True)

    def update_masses_u(self, new_masses: Union[Callable, ArrayLike]):
        """Replace masses (Morton order or callable) and rebuild."""
        self._update(new_masses, "mass", ordered=False)

    def update_masses_o(self, new_masses: Union[Callable, ArrayLike]):
        self._update(new_masses, "mass", ordered=True)

    # --------------------------------------------------------- accessors
    @property
    def nparts(self) -> int:
        return int(self._td.pos.shape[0])

    def __len__(self) -> int:
        return self.nparts

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def box_size(self) -> float:
        return float(self._box)

    @property
    def config(self) -> TreeConfig:
        return self._cfg

    @property
    def perm(self):
        """Morton slot -> original user index (composed across updates)."""
        return self._orig_perm

    @property
    def inv_perm(self):
        """Original user index -> Morton slot."""
        return self._inv_orig

    @property
    def last_perm(self):
        """Permutation applied by the most recent sort/update only."""
        return self._last_perm

    @property
    def positions_u(self):
        return self._td.pos

    @property
    def positions_o(self):
        return self._td.pos[self._inv_orig]

    @property
    def masses_u(self):
        return self._td.mass

    @property
    def masses_o(self):
        return self._td.mass[self._inv_orig]

    @property
    def tree_data(self):
        """The underlying flat tree (TreeData)."""
        return self._td

    @property
    def n_nodes(self) -> int:
        return int(self._td.n_nodes)

    def __repr__(self):
        c = self._cfg
        return (f"{type(self).__name__}(n={self.nparts}, ndim={c.ndim}, "
                f"dtype={c.dtype}, mac={c.mac}, max_leaf_n={c.max_leaf_n}, "
                f"ncrit={c.ncrit}, nodes={self.n_nodes}, "
                f"box={self.box_size:g}, device={self._device})")


class octree(Tree):
    """3D tree."""

    def __init__(self, *args, **kw):
        if kw.setdefault("ndim", 3) != 3:
            raise ValueError("octree is 3-D")
        super().__init__(*args, **kw)


class quadtree(Tree):
    """2D tree."""

    def __init__(self, *args, **kw):
        if kw.setdefault("ndim", 2) != 2:
            raise ValueError("quadtree is 2-D")
        super().__init__(*args, **kw)
