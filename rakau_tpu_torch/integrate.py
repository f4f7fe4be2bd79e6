"""Leapfrog (kick-drift-kick) integration harness with a tree rebuild every
step, and energy diagnostics. Counterpart of `rakau_tpu.integrate`.

Every function runs where the state's tensors live and never moves them.
As in the reference, most functions come in twins:

  * the whole-call twins (`acc_pot`, `leapfrog_step`,
    `leapfrog_step_morton`, `total_energy`), which the reference jits
    whole: builds and queries (`engine._query_impl`, every chunk of the
    tile capacity, as `engine.acc_pot_u`) run as one CUDA graph on CUDA
    tensors, captured at a key's first call and replayed after;
  * the `_host` twins, which run each build through `engine.build_tree`
    (its own graph) and each query through `engine.acc_pot_u_host` (the
    live chunks in sliced graphs, one host read of n_tiles a query).

Both twins of a pair run the same ops on the same sums, so their results
are equal bit for bit. `graph=None` takes the graphs on CUDA tensors and
runs eagerly on CPU tensors; `graph=False` runs eagerly on the card too
(the A/B); `graph=True` on CPU tensors raises ValueError. A numeric
box_size is part of a graph's key; theta, eps, G and dt, as in the
reference's jitted calls, are inputs: 0-dim tensors of the state's dtype
on its device, so a new opening angle, softening, G or step size (or -dt)
replays the same graph. The _host twins hand theta, eps and G on as they
were given: `engine.acc_pot_u_host` reads eps's value for its per-tree
state and makes the tensors.

    rakau_tpu.integrate                  rakau_tpu_torch.integrate
    NBodyState                           NBodyState
    acc_pot                              acc_pot
    acc_pot_host                         acc_pot_host
    leapfrog_step                        leapfrog_step
    leapfrog_step_host                   leapfrog_step_host
    leapfrog_step_morton                 leapfrog_step_morton
    leapfrog_step_morton_host            leapfrog_step_morton_host
    leapfrog_step_morton_host_safe       leapfrog_step_morton_host_safe
    total_energy                         total_energy
    total_energy_host                    total_energy_host
    exact_total_energy                   exact_total_energy

Two differences, both refusals where the reference carries on: a tree
build whose node or tile capacity overflowed raises (in a whole call
after the replay: the graph returns each build's flag), and the energies
raise on an overflowed query instead of returning the energy of
truncated interaction lists (the reference ignores those flags). The
energies use a pots-only query and are summed in float64, in Morton
order in both twins. The reference's `slice_chunks` is not taken:
`engine.acc_pot_u_host` chooses the slices.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build as _build
from . import direct as _direct
from . import engine as _engine
from . import particles as _particles
from .config import TreeConfig, grow_overflowed


class NBodyState(NamedTuple):
    pos: torch.Tensor    # [N, D] (any consistent order)
    vel: torch.Tensor    # [N, D]
    mass: torch.Tensor   # [N]


# ------------------------------------------------------ the shared bodies
# Each takes `build(pos, mass, cfg, box_size)` and `query(td, cfg, theta,
# eps, G, mode=)`: build.build_tree and engine._query_impl in a whole
# call (captured as one graph; theta, eps and G are what engine.scalars
# returns, G the kernels' buffer scal), _host_build and
# engine.acc_pot_u_host in a _host twin (the caller's numbers or
# tensors). Each returns the builds' overflow flag last.

def _acc_pot(pos, mass, cfg, theta, eps, G, box_size, build, query):
    td = build(pos, mass, cfg, box_size)
    acc_u, pot_u, ovf, _ = query(td, cfg, theta, eps, G)
    return acc_u[td.inv_perm], pot_u[td.inv_perm], ovf, td.overflow


def _step(state, dt, cfg, theta, eps, G, box_size, build, query):
    acc0, _, ovf0, b0 = _acc_pot(state.pos, state.mass, cfg, theta, eps, G,
                                 box_size, build, query)
    vel_h = state.vel + 0.5 * dt * acc0
    pos1 = state.pos + dt * vel_h
    acc1, _, ovf1, b1 = _acc_pot(pos1, state.mass, cfg, theta, eps, G,
                                 box_size, build, query)
    vel1 = vel_h + 0.5 * dt * acc1
    return NBodyState(pos1, vel1, state.mass), ovf0 | ovf1, b0 | b1


def _step_morton(state, dt, cfg, theta, eps, G, box_size, build, query):
    td0 = build(state.pos, state.mass, cfg, box_size)
    acc0, _, ovf0, _ = query(td0, cfg, theta, eps, G)
    vel_h = state.vel[td0.perm] + 0.5 * dt * acc0
    pos1 = td0.pos + dt * vel_h
    td1 = build(pos1, td0.mass, cfg, box_size)
    acc1, _, ovf1, _ = query(td1, cfg, theta, eps, G)
    vel1 = vel_h[td1.perm] + 0.5 * dt * acc1
    step_perm = td0.perm[td1.perm]
    return (NBodyState(td1.pos, vel1, td1.mass), ovf0 | ovf1, step_perm,
            td0.overflow | td1.overflow)


def _kinetic(state: NBodyState) -> torch.Tensor:
    v = state.vel.double()
    return 0.5 * (state.mass.double() * (v * v).sum(1)).sum()


def _energy(state, cfg, theta, eps, G, box_size, build, query):
    td = build(state.pos, state.mass, cfg, box_size)
    _, pot_u, ovf, _ = query(td, cfg, theta, eps, G, mode="pot")
    pe = 0.5 * (td.mass.double() * pot_u.double()).sum()
    return _kinetic(state) + pe, ovf, td.overflow


# ------------------------------------------------------------- the checks
def _check_build(overflow):
    if bool(overflow):
        raise RuntimeError(
            "tree build overflowed its node or tile capacity; set "
            "cfg.node_cap / cfg.tile_cap larger")


def _check_energy_query(ovf):
    flags = ovf.cpu().tolist()
    if any(flags):
        raise RuntimeError(
            f"total_energy: the query overflowed its capacities {flags} "
            "(grow them, e.g. through Tree(...).pots_o and tree.config)")


def _host_build(pos, mass, cfg, box_size, graph):
    td = _engine.build_tree(pos, mass, cfg, box_size, graph=graph)
    _check_build(td.overflow)
    return td


def _args(pos, cfg, graph, box_size):
    """(whether to use graphs, box_size on pos's device where a tensor)."""
    if isinstance(box_size, torch.Tensor):
        box_size = box_size.to(pos.device)
    return _engine._use_graph(graph, pos, cfg), box_size


def _scalars(pos, cfg, graph, box_size, theta, eps, G):
    """_args, then theta, eps and the kernels' buffer scal on pos.device
    (engine.scalars): the arguments of a whole twin as a graph's key
    takes them, the three tensors its inputs."""
    return (_args(pos, cfg, graph, box_size)
            + _engine.scalars(pos, theta, eps, G))


def _dt(dt, pos):
    """dt as a 0-dim tensor of pos.dtype on pos.device (a number filled in
    there): a graph's input, not part of its key."""
    return _particles.scalar_tensor(dt, pos)


def _host(graph):
    """(build, query) of a _host twin."""
    return (functools.partial(_host_build, graph=graph),
            functools.partial(_engine.acc_pot_u_host, graph=graph))


def _whole(graph, body, *args, query=_engine._query_impl):
    """body(*args, build.build_tree, query), on the card as one CUDA graph
    (engine._run). query: engine._query_impl, or the sharded query
    (parallel.sharded)."""
    return _engine._run(graph, body, *args, _build.build_tree, query)


# ---------------------------------------------------------------- the twins
def acc_pot(pos, mass, cfg: TreeConfig, theta, eps, G=1.0, box_size=None,
            graph=None):
    """Build + query in one call (the per-step rebuild pattern), on the card
    one CUDA graph. Returns acc [N, D] and pot [N] in the INPUT order, and
    the query's overflow flags [4]; raises after the call if the build
    overflowed."""
    graph, box_size, theta, eps, scal = _scalars(pos, cfg, graph, box_size,
                                              theta, eps, G)
    acc, pot, ovf, b_ovf = _whole(graph, _acc_pot, pos, mass, cfg, theta,
                                  eps, scal, box_size)
    _check_build(b_ovf)
    return acc, pot, ovf


def acc_pot_host(pos, mass, cfg: TreeConfig, theta, eps, G=1.0,
                 box_size=None, graph=None):
    """acc_pot's _host twin: the build's graph, then the sliced query."""
    graph, box_size = _args(pos, cfg, graph, box_size)
    return _acc_pot(pos, mass, cfg, theta, eps, G, box_size,
                    *_host(graph))[:3]


def leapfrog_step(state: NBodyState, dt, cfg: TreeConfig, theta, eps,
                  G=1.0, box_size=None, graph=None):
    """One KDK step with a rebuild for each force evaluation, the state
    kept in its input order, on the card one CUDA graph. Returns
    (new_state, overflow_flags [4])."""
    graph, box_size, theta, eps, scal = _scalars(state.pos, cfg, graph,
                                              box_size, theta, eps, G)
    new, ovf, b_ovf = _whole(graph, _step, state, _dt(dt, state.pos), cfg,
                             theta, eps, scal, box_size)
    _check_build(b_ovf)
    return new, ovf


def leapfrog_step_host(state: NBodyState, dt, cfg: TreeConfig, theta, eps,
                       G=1.0, box_size=None, graph=None):
    """leapfrog_step's _host twin."""
    graph, box_size = _args(state.pos, cfg, graph, box_size)
    return _step(state, _dt(dt, state.pos), cfg, theta, eps, G, box_size,
                 *_host(graph))[:2]


def leapfrog_step_morton(state: NBodyState, dt, cfg: TreeConfig, theta,
                         eps, G=1.0, box_size=None, graph=None):
    """KDK step that keeps the state in Morton order across steps (each
    rebuild sorts the previous step's Morton order, so its gathers are
    local; the sort is a full one), on the card one CUDA graph. Returns
    (new_state in the new Morton order, overflow_flags [4], step_perm):
    step_perm maps the new slots to the input order of `state` (compose
    across steps for the original order)."""
    graph, box_size, theta, eps, scal = _scalars(state.pos, cfg, graph,
                                              box_size, theta, eps, G)
    new, ovf, perm, b_ovf = _whole(graph, _step_morton, state,
                                   _dt(dt, state.pos), cfg, theta, eps,
                                   scal, box_size)
    _check_build(b_ovf)
    return new, ovf, perm


def leapfrog_step_morton_host(state: NBodyState, dt, cfg: TreeConfig, theta,
                              eps, G=1.0, box_size=None, graph=None):
    """leapfrog_step_morton's _host twin."""
    graph, box_size = _args(state.pos, cfg, graph, box_size)
    return _step_morton(state, _dt(dt, state.pos), cfg, theta, eps, G,
                        box_size, *_host(graph))[:3]


def leapfrog_step_morton_host_safe(state: NBodyState, dt, cfg: TreeConfig,
                                   theta, eps, G=1.0, box_size=None,
                                   max_retries: int = 4, graph=None):
    """leapfrog_step_morton_host with cap-overflow retry: a step whose
    interaction lists overflowed (truncated forces) is discarded and redone
    from the same state with the overflowed capacities doubled.

    Returns (new_state, overflow_flags (all False), step_perm, cfg,
    n_retries); callers thread the grown cfg into later steps so that the
    growth is paid once."""
    n_retries = 0
    for _ in range(max_retries + 1):
        new_state, ovf, perm = leapfrog_step_morton_host(
            state, dt, cfg, theta, eps, G, box_size, graph)
        flags = ovf.cpu().tolist()
        if not any(flags):
            return new_state, ovf, perm, cfg, n_retries
        cfg = grow_overflowed(cfg, flags)
        n_retries += 1
    raise RuntimeError(
        f"leapfrog step still overflowing after {max_retries} cap "
        f"doublings (flags {flags})")


def total_energy(state: NBodyState, cfg: TreeConfig, theta, eps, G=1.0,
                 box_size=None, graph=None) -> float:
    """Kinetic + potential energy (E_pot = 0.5 sum m_i phi_i) with tree
    potentials from a pots-only query, on the card one CUDA graph: the
    drift diagnostic at sizes where the exact sum is out of reach (pass a
    small theta). Raises on an overflowed build or query."""
    graph, box_size, theta, eps, scal = _scalars(state.pos, cfg, graph,
                                              box_size, theta, eps, G)
    e, ovf, b_ovf = _whole(graph, _energy, state, cfg, theta, eps, scal,
                           box_size)
    _check_build(b_ovf)
    _check_energy_query(ovf)
    return float(e)


def total_energy_host(state: NBodyState, cfg: TreeConfig, theta, eps,
                      G=1.0, box_size=None, graph=None) -> float:
    """total_energy's _host twin."""
    graph, box_size = _args(state.pos, cfg, graph, box_size)
    e, ovf, _ = _energy(state, cfg, theta, eps, G, box_size, *_host(graph))
    _check_energy_query(ovf)
    return float(e)


def exact_total_energy(state: NBodyState, eps=0.0, G=1.0) -> float:
    """Kinetic + potential energy with direct-sum potentials."""
    _, pot = _direct.direct_acc_pot(state.pos, state.mass, eps=eps, G=G)
    pe = 0.5 * (state.mass.double() * pot.double()).sum()
    return float(_kinetic(state) + pe)
