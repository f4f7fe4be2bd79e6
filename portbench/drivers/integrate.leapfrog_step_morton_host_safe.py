"""The driver of `integrate.leapfrog_step_morton_host_safe`: a closed loop
of leapfrog steps from the state left at set-up."""
from __future__ import annotations

import torch

from portbench import entries, inputs
from portbench.reference import compare
from portbench.reference.direct import direct_sum, kicks


class Driver(entries.Entry):
    """`integrate.leapfrog_step_morton_host_safe` from the state left at
    set-up: each call is one kick-drift-kick step, two builds and two
    queries, returning the state in the new Morton order with the step's
    permutation. The configuration's grown caps are threaded on, as its
    callers do; the set-up's steps are judged too."""

    judge_setup = True

    def setup(self):
        from rakau_tpu_torch import integrate
        pos, mass = self.particles()
        self.state = integrate.NBodyState(pos, torch.zeros_like(pos), mass)
        self.rows = torch.as_tensor(inputs.sample(
            self.n, self.limits["step_targets"], self.seed, 2),
            device=self.device)
        self.retries = []
        self.warm()
        self.info["caps_grown"] = entries.grown(self.cfg0, self.cfg)

    def _call(self):
        from rakau_tpu_torch import integrate
        before = self.state
        self.state, _, perm, self.cfg, r = \
            integrate.leapfrog_step_morton_host_safe(
                before, self.config["dt"], self.cfg, self.theta, self.eps,
                self.G, box_size=self.config["box_size"])
        self.records.append((before.pos.clone(), before.vel.clone(),
                             before.mass.clone(), perm,
                             self.state.pos[self.rows],
                             self.state.vel[self.rows]))
        self.retries.append(r)

    def judge(self) -> tuple:
        from rakau_tpu_torch import integrate
        # BASELINE's force error: the step's configuration queried on the
        # last state, a call of the program outside the window
        samp = torch.as_tensor(inputs.sample(
            self.n, self.limits["targets"], self.seed, 1), device=self.device)
        acc, pot, ovf = integrate.acc_pot_host(
            self.state.pos, self.state.mass, self.cfg, self.theta, self.eps,
            self.G, box_size=self.config["box_size"])
        if bool(ovf.any()):
            raise RuntimeError("the force query on the last state "
                               "overflowed")
        last = (acc[samp], pot[samp])
        pos, mass = self.state.pos, self.state.mass
        self.state = acc = pot = None
        self.free()
        ref = direct_sum(pos, mass, pos[samp], samp, self.eps, self.G)
        force_err = compare.answers(*last, *ref)["force_rms"]
        dt, rows = self.config["dt"], self.rows
        worst = {}
        bad = 0
        for x, v, m, perm, x1, v1 in self.records:
            bad += int(not compare.is_permutation(perm))
            i = perm[rows]
            if self.control_dtype is not None:
                x1, v1 = kicks(x, v, m, i, dt, self.eps, self.control_dtype)
            rx1, rv1 = kicks(x, v, m, i, dt, self.eps)
            for k, val in compare.step(x[i], v[i], x1, v1, rx1,
                                       rv1).items():
                worst[k] = max(worst.get(k, 0.0), val)
        checks = {k: worst.pop(k) for k in self.limits["checks"]
                  if k in worst}
        checks["perm_bad"] = float(bad)
        return (checks, dict(worst, force_err_rms=force_err,
                             steps_judged=len(self.records),
                             retries=list(self.retries)))
