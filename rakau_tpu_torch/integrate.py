"""Leapfrog (kick-drift-kick) integration harness with a tree rebuild every
step, and energy diagnostics. Counterpart of `rakau_tpu.integrate`.

Every function runs where the state's tensors live and never moves them.
The reference has two twins of most functions, one jitted as a whole
(`acc_pot`, `leapfrog_step`, `leapfrog_step_morton`, `total_energy`,
around `engine.acc_pot_u`) and one (`_host`, with `slice_chunks`) that
keeps each dispatch under the TPU watchdog. Here each pair is one
function, and each runs its queries through `engine.acc_pot_u_host`:
on CUDA tensors every slice of chunks, the tail and a gwalk query replay
CUDA graphs (engine.py, graphs.py), the host-sliced twin's shape. The
jitted twins' whole-call executable has no counterpart yet: the build
runs eagerly between the graphs (`build.build_tree` copies a
`box_size` given as a number to the device, and `_build_tree` reads
`td.overflow` on the host), so a whole step as one graph is a later
step; `engine.acc_pot_u` is the whole query as one graph.

    rakau_tpu.integrate                      rakau_tpu_torch.integrate
    NBodyState                               NBodyState
    acc_pot, acc_pot_host                    acc_pot
    leapfrog_step, leapfrog_step_host        leapfrog_step
    leapfrog_step_morton,
      leapfrog_step_morton_host              leapfrog_step_morton
    leapfrog_step_morton_host_safe           leapfrog_step_morton_safe
    total_energy, total_energy_host          total_energy
    exact_total_energy                       exact_total_energy

Two differences, both refusals where the reference carries on: a tree
build whose node or tile capacity overflowed raises, and `total_energy`
raises on an overflowed query instead of returning the energy of
truncated interaction lists (the reference's `total_energy_host` ignores
those flags). Energies are summed in float64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build as _build
from . import direct as _direct
from . import engine as _engine
from .config import TreeConfig, grow_overflowed


class NBodyState(NamedTuple):
    pos: torch.Tensor    # [N, D] (any consistent order)
    vel: torch.Tensor    # [N, D]
    mass: torch.Tensor   # [N]


def _build_tree(pos, mass, cfg: TreeConfig, box_size):
    td = _build.build_tree(pos, mass, cfg, box_size)
    if bool(td.overflow):
        raise RuntimeError(
            "tree build overflowed its node or tile capacity; set "
            "cfg.node_cap / cfg.tile_cap larger")
    return td


def _query(td, cfg: TreeConfig, theta, eps, G, mode="both"):
    return _engine.acc_pot_u_host(td, cfg, float(theta), float(eps),
                                  float(G), mode=mode)


def acc_pot(pos, mass, cfg: TreeConfig, theta, eps, G=1.0, box_size=None):
    """Build + query (the per-step rebuild pattern). Returns acc [N, D] and
    pot [N] in the INPUT order, and the query's overflow flags [4]."""
    td = _build_tree(pos, mass, cfg, box_size)
    acc_u, pot_u, ovf, _ = _query(td, cfg, theta, eps, G)
    return acc_u[td.inv_perm], pot_u[td.inv_perm], ovf


def leapfrog_step(state: NBodyState, dt, cfg: TreeConfig, theta, eps,
                  G=1.0, box_size=None):
    """One KDK step with a rebuild for each force evaluation, the state
    kept in its input order. Returns (new_state, overflow_flags [4])."""
    acc0, _, ovf0 = acc_pot(state.pos, state.mass, cfg, theta, eps, G,
                            box_size)
    vel_h = state.vel + 0.5 * dt * acc0
    pos1 = state.pos + dt * vel_h
    acc1, _, ovf1 = acc_pot(pos1, state.mass, cfg, theta, eps, G, box_size)
    vel1 = vel_h + 0.5 * dt * acc1
    return NBodyState(pos1, vel1, state.mass), ovf0 | ovf1


def leapfrog_step_morton(state: NBodyState, dt, cfg: TreeConfig, theta,
                         eps, G=1.0, box_size=None):
    """KDK step that keeps the state in Morton order across steps (each
    rebuild sorts the previous step's Morton order, so its gathers are
    local; the sort is a full one). Returns (new_state in the new Morton
    order, overflow_flags [4], step_perm): step_perm maps the new slots to
    the input order of `state` (compose across steps for the original
    order)."""
    td0 = _build_tree(state.pos, state.mass, cfg, box_size)
    acc0, _, ovf0, _ = _query(td0, cfg, theta, eps, G)
    vel_h = state.vel[td0.perm] + 0.5 * dt * acc0
    pos1 = td0.pos + dt * vel_h
    td1 = _build_tree(pos1, td0.mass, cfg, box_size)
    acc1, _, ovf1, _ = _query(td1, cfg, theta, eps, G)
    vel1 = vel_h[td1.perm] + 0.5 * dt * acc1
    step_perm = td0.perm[td1.perm]
    return NBodyState(td1.pos, vel1, td1.mass), ovf0 | ovf1, step_perm


def leapfrog_step_morton_safe(state: NBodyState, dt, cfg: TreeConfig,
                              theta, eps, G=1.0, box_size=None,
                              max_retries: int = 4):
    """leapfrog_step_morton with cap-overflow retry: a step whose
    interaction lists overflowed (truncated forces) is discarded and redone
    from the same state with the overflowed capacities doubled.

    Returns (new_state, overflow_flags (all False), step_perm, cfg,
    n_retries); callers thread the grown cfg into later steps so that the
    growth is paid once."""
    n_retries = 0
    for _ in range(max_retries + 1):
        new_state, ovf, perm = leapfrog_step_morton(
            state, dt, cfg, theta, eps, G, box_size)
        flags = ovf.cpu().tolist()
        if not any(flags):
            return new_state, ovf, perm, cfg, n_retries
        cfg = grow_overflowed(cfg, flags)
        n_retries += 1
    raise RuntimeError(
        f"leapfrog step still overflowing after {max_retries} cap "
        f"doublings (flags {flags})")


def _kinetic(state: NBodyState) -> torch.Tensor:
    v = state.vel.double()
    return 0.5 * (state.mass.double() * (v * v).sum(1)).sum()


def total_energy(state: NBodyState, cfg: TreeConfig, theta, eps, G=1.0,
                 box_size=None) -> float:
    """Kinetic + potential energy (E_pot = 0.5 sum m_i phi_i) with tree
    potentials from a pots-only query: the drift diagnostic at sizes where
    the exact sum is out of reach (pass a small theta). Raises on an
    overflowed query."""
    td = _build_tree(state.pos, state.mass, cfg, box_size)
    _, pot_u, ovf, _ = _query(td, cfg, theta, eps, G, mode="pot")
    flags = ovf.cpu().tolist()
    if any(flags):
        raise RuntimeError(
            f"total_energy: the query overflowed its capacities {flags} "
            "(grow them, e.g. through Tree(...).pots_o and tree.config)")
    pe = 0.5 * (td.mass.double() * pot_u.double()).sum()
    return float(_kinetic(state) + pe)


def exact_total_energy(state: NBodyState, eps=0.0, G=1.0) -> float:
    """Kinetic + potential energy with direct-sum potentials."""
    _, pot = _direct.direct_acc_pot(state.pos, state.mass, eps=eps, G=G)
    pe = 0.5 * (state.mass.double() * pot.double()).sum()
    return float(_kinetic(state) + pe)
