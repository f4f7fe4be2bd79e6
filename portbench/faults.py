"""Faults planted in the program's timed path, for the checks' readings
(portbench/readings.py --fault <name>) and for the tests that see
`correct` come out false. Each takes `patch(obj, name, value)`, which sets
an attribute (pytest's monkeypatch.setattr, or `setattr` in a process
that runs only the fault)."""
from __future__ import annotations

import torch


def half_left_out(patch):
    """Half of each query's particles answered with zeros."""
    from rakau_tpu_torch import engine
    real = engine.acc_pot_u_host

    def half(*a, **kw):
        acc, pot, ovf, mx = real(*a, **kw)
        h = acc.shape[0] // 2
        return (torch.cat([acc[:h], torch.zeros_like(acc[h:])]),
                torch.cat([pot[:h], torch.zeros_like(pot[h:])]), ovf, mx)
    patch(engine, "acc_pot_u_host", half)


def answer_altered(patch):
    """K1's accelerations doubled where they are produced."""
    from rakau_tpu_torch.kernels import dispatch
    real = dispatch.eval_shared

    def altered(*a, **kw):
        acc, pot = real(*a, **kw)
        return 2 * acc, pot
    patch(dispatch, "eval_shared", altered)


def state_unchanged(patch):
    """A leapfrog step that returns its state as it was given."""
    from rakau_tpu_torch import integrate

    def unchanged(state, *a, **kw):
        n = state.pos.shape[0]
        return (state, torch.zeros(4, dtype=torch.bool),
                torch.arange(n, device=state.pos.device))
    patch(integrate, "leapfrog_step_morton_host", unchanged)


def second_query_left_out(patch):
    """A leapfrog step whose second query (after the drift's rebuild)
    answers zeros: the second half-kick is lost, the first half of the
    step is sound."""
    from rakau_tpu_torch import integrate
    real = integrate._step_morton

    def body(state, dt, cfg, theta, eps, G, box_size, build, query):
        calls = []

        def second_zero(*a, **kw):
            acc, pot, ovf, mx = query(*a, **kw)
            calls.append(1)
            if len(calls) == 2:
                acc = torch.zeros_like(acc)
            return acc, pot, ovf, mx
        return real(state, dt, cfg, theta, eps, G, box_size, build,
                    second_zero)
    patch(integrate, "_step_morton", body)


def exchange_left_out(patch):
    """The gather of the cards' sums to card 0 keeps card 0's alone."""
    from rakau_tpu_torch.parallel import mesh
    real = mesh.gather_cat

    def first_only(xs, dev):
        return real([xs[0]] + [torch.zeros_like(x) for x in xs[1:]], dev)
    patch(mesh, "gather_cat", first_only)


FAULTS = {f.__name__: f for f in (half_left_out, answer_altered,
                                  state_unchanged, second_query_left_out,
                                  exchange_left_out)}
