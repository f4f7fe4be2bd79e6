"""Static configuration for the PyTorch Barnes-Hut engine.

Counterpart of `rakau_tpu.config`: the same fields, defaults and
validation (product-mode matrix included), so that
`TreeConfig(**dataclasses.asdict(jax_cfg))` builds the same configuration.
The per-call theta/eps/G stay call arguments.

The engine (engine.py) runs every mode this config accepts: the shared,
lmac, gwalk and lists traversals. In lists mode (and for the quadrupole
with "local" or "grid", which runs there) the caps are per tile. In lmac
mode frontier_cap is the capacity of a slice's candidate table. In gwalk
mode the four growable capacities have global meaning: m2p_cap is
the total of (tile, node) M2P incidences, p2p_leaf_cap of opened (tile,
leaf) incidences, p2p_src_cap the pool rows, frontier_cap the peak
global frontier of (tile, node) pairs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

# Multipole acceptance criteria (reference: `enum class mac { bh, bh_geom }`).
MAC_BH = "bh"
MAC_BH_GEOM = "bh_geom"
_VALID_MACS = (MAC_BH, MAC_BH_GEOM)


def default_max_depth(ndim: int) -> int:
    # 21 bits/dim in 3D, 31 in 2D: codes fit in 63 bits of one int64.
    return {1: 62, 2: 31, 3: 21}[ndim]


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Hashable static config.

    Field meanings are those of `rakau_tpu.config.TreeConfig`: ndim,
    dtype, max_depth (bits per dimension of the Morton key), max_leaf_n,
    ncrit (target-tile size), mac, node_cap/tile_cap (static capacities,
    None = auto), the four growable interaction-list capacities
    (frontier_cap, m2p_cap, p2p_leaf_cap, p2p_src_cap), tile_chunk (tiles
    per evaluated chunk; bounds peak memory), multipole_order,
    kernel_backend, traversal_mode, farfield, local_order, grid_level,
    the grid2/gwalk knobs, accum and local_gamma.
    """

    ndim: int = 3
    dtype: str = "float32"
    max_depth: Optional[int] = None
    max_leaf_n: int = 64
    ncrit: int = 256
    mac: str = MAC_BH
    node_cap: Optional[int] = None
    tile_cap: Optional[int] = None
    frontier_cap: int = 1024
    m2p_cap: int = 4096
    p2p_leaf_cap: int = 512
    p2p_src_cap: int = 8192
    tile_chunk: int = 64
    multipole_order: int = 0
    kernel_backend: str = "auto"  # "auto" | "xla" | "pallas"
    traversal_mode: str = "shared"  # "shared" | "lists" | "lmac" | "gwalk"
    farfield: str = "local"  # "local" | "m2p" | "grid" | "grid2"
    local_order: int = 3
    grid_level: Optional[int] = None
    grid_multipole_order: Optional[int] = None
    grid_sep: int = 3
    grid_occupancy: int = 32
    accum: str = "fp32"
    pool_block: int = 512
    pool_window: int = 262144
    pool_group: int = 8
    gwalk_round_caps: Optional[tuple] = None
    local_gamma: float = 4.0

    def __post_init__(self):
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.mac not in _VALID_MACS:
            raise ValueError(f"mac must be one of {_VALID_MACS}, got {self.mac!r}")
        md = self.max_depth
        if md is None:
            object.__setattr__(self, "max_depth", default_max_depth(self.ndim))
        elif not (1 <= md * self.ndim <= 63):
            raise ValueError(
                f"max_depth*ndim must be in [1, 63], got {md}*{self.ndim}")
        if self.max_leaf_n < 1:
            raise ValueError("max_leaf_n must be >= 1")
        if self.ncrit < 1:
            raise ValueError("ncrit must be >= 1")
        if self.multipole_order not in (0, 2):
            raise ValueError("multipole_order must be 0 (monopole) or 2 (quadrupole)")
        if self.kernel_backend not in ("auto", "xla", "pallas"):
            raise ValueError("kernel_backend must be auto|xla|pallas")
        if self.traversal_mode not in ("shared", "lists", "lmac", "gwalk"):
            raise ValueError(
                "traversal_mode must be shared|lists|lmac|gwalk")
        if self.traversal_mode == "gwalk":
            if self.farfield not in ("m2p", "grid", "grid2"):
                raise ValueError(
                    "traversal_mode='gwalk' supports farfield='m2p', "
                    "'grid' or 'grid2'")
            if (self.pool_block < 128
                    or self.pool_window % self.pool_block):
                raise ValueError(
                    "pool_window must be a multiple of pool_block "
                    "(>= 128)")
            if self.pool_group < 1:
                raise ValueError("pool_group must be >= 1")
        # product-mode matrix: "lists" and quadrupole with the tile-
        # expansion far fields are diagnostic-only (RAKAU_DIAG_MODES=1)
        diag = os.environ.get("RAKAU_DIAG_MODES") == "1"
        if self.traversal_mode == "lists" and not diag:
            raise ValueError(
                "traversal_mode='lists' is diagnostic-only (superseded "
                "by 'shared'/'lmac'; set RAKAU_DIAG_MODES=1 to allow)")
        if (self.multipole_order >= 2
                and self.farfield in ("local", "grid") and not diag):
            raise ValueError(
                "multipole_order=2 requires farfield='m2p' or 'grid2' "
                "(with 'local'/'grid' the quadrupole falls back to the "
                "diagnostic lists path; set RAKAU_DIAG_MODES=1 to allow)")
        if self.farfield not in ("local", "m2p", "grid", "grid2"):
            raise ValueError("farfield must be local|m2p|grid|grid2")
        if self.farfield == "grid2":
            if self.traversal_mode not in ("shared", "lmac", "gwalk"):
                raise ValueError(
                    "farfield='grid2' requires traversal_mode='shared', "
                    "'lmac' or 'gwalk'")
            if not (2 <= self.local_order <= 8):
                raise ValueError("grid2 local_order must be in [2, 8]")
            gq = self.grid_multipole_order
            if gq is not None and not (0 <= gq <= 8):
                raise ValueError("grid_multipole_order must be in [0, 8]")
            if self.grid_sep < 2:
                raise ValueError("grid_sep must be >= 2")
            cap = {1: 21, 2: 10, 3: 7}[self.ndim]
            if self.grid_level is not None and not (
                    0 <= self.grid_level <= cap):
                raise ValueError(
                    f"grid2 grid_level must be in [0, {cap}] for ndim="
                    f"{self.ndim}")
            if self.grid_occupancy < 1:
                raise ValueError("grid_occupancy must be >= 1")
        elif self.local_order not in (2, 3):
            raise ValueError("local_order must be 2 or 3")
        if self.local_gamma <= 1.0:
            raise ValueError("local_gamma must be > 1 (rho = 1/gamma < 1)")
        if self.accum not in ("fp32", "compensated"):
            raise ValueError("accum must be fp32|compensated")

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def code_bits(self) -> int:
        return self.max_depth * self.ndim

    def node_capacity(self, n_particles: int) -> int:
        if self.node_cap is not None:
            return self.node_cap
        # 8x the leaf count plus slack; overflow is flagged and the Tree
        # retries with a larger capacity
        return int(8 * (n_particles // max(self.max_leaf_n, 1) + 1)
                   + 4 ** self.ndim)

    def tile_capacity(self, n_particles: int) -> int:
        """Static capacity of the target-tile table (~1.3x N/ncrit real
        tiles; grid clipping adds up to one tile per occupied cell)."""
        if self.tile_cap is not None:
            return self.tile_cap
        cap = 2 * (-(-n_particles // self.ncrit)) + 64
        L0 = 0
        if self.farfield == "grid":
            from .grid import effective_grid_level
            L0 = effective_grid_level(self, n_particles)
        elif self.farfield == "grid2" and self.traversal_mode == "gwalk":
            # gwalk clips its tiles at grid2's cells too (build.py)
            from .grid2 import effective_grid_level
            L0 = effective_grid_level(self, n_particles)
        if L0 > 0:
            cap += min((1 << L0) ** self.ndim, n_particles)
        return cap

    def with_(self, **kw) -> "TreeConfig":
        return dataclasses.replace(self, **kw)


# Canonical order of the growable capacities: the [4] overflow-flag /
# maxima vectors of engine.acc_pot_u_host align with it.
OVF_FIELDS = ("m2p_cap", "p2p_leaf_cap", "p2p_src_cap", "frontier_cap")


def grow_overflowed(cfg: TreeConfig, flags) -> TreeConfig:
    """Double exactly the capacities whose overflow flag is set."""
    return cfg.with_(**{f: 2 * getattr(cfg, f)
                        for f, hit in zip(OVF_FIELDS, flags) if hit})


def fit_caps(cfg: TreeConfig, maxima, slack: float = 1.25,
             quantum: int = 512) -> TreeConfig:
    """Shrink the capacities to the maxima a query measured (the [4]
    vector of max m2p, p2p_src, frontier and p2p_leaf counts), with
    `slack` and rounded up to `quantum`."""
    stats = [int(x) for x in maxima]
    m2p_max, p2p_max, f_max = stats[:3]
    leaf_max = stats[3] if len(stats) > 3 else p2p_max // 4

    def fit(v, q):
        return max(q, -(-int(v * slack) // q) * q)

    return cfg.with_(
        m2p_cap=fit(m2p_max, quantum),
        p2p_src_cap=fit(p2p_max, 2 * quantum),
        p2p_leaf_cap=max(256, fit(leaf_max, 256)),
        frontier_cap=max(256, fit(f_max, 256)))


def fit_round_caps(round_counts, slack: float = 1.3,
                   quantum: int = 256) -> tuple:
    """Per-round frontier capacities for the unrolled gwalk walk from the
    open pairs after each round that a dynamic walk measured
    (traversal4.GlobalLists.round_counts), with `slack` and rounded up to
    `quantum`. Trailing zero rounds are dropped: the unrolled walk does
    not run them."""
    counts = [int(c) for c in round_counts]
    while counts and counts[-1] == 0:
        counts.pop()
    return tuple(max(quantum, -(-int(c * slack) // quantum) * quantum)
                 for c in counts)
