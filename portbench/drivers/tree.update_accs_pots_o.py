"""The driver of `Tree.update_positions_o` + `Tree.accs_pots_o`: a closed
loop of updates and queries on a tree built at set-up, the positions
alternating between a drifted and the drawn set."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import entries, inputs, inputs_disk
from portbench.reference import compare
from portbench.reference.direct import PASS_BYTES, SOURCE_BLOCK, direct_sum

DISTRIBUTIONS = {**inputs.DISTRIBUTIONS,
                 "disk_galaxy": inputs_disk.disk_galaxy}
# the precision probe (comp_pot_max): the first PROBE_N particles of the
# seed's set, PROBE_TARGETS sampled targets of them
PROBE_N = 65536
PROBE_TARGETS = 1024


def stream_seed(seed: int, stream: int) -> int:
    """A torch.Generator seed of its own for (seed, stream)."""
    return int(np.random.default_rng([seed, stream]).integers(2 ** 63))


def lower_sum(src_pos, src_mass, tgt_pos, tgt_idx, eps: float, G: float,
              dtype):
    """The checks' control: the reference's direct sum (direct_sum's
    passes) computed and accumulated in `dtype`, a pair whose positions
    coincide in `dtype` left out as the own term is. In bfloat16 a 64M
    disk's neighbours round onto one point, where 1/r is inf and the sum
    NaN: this keeps the control's reading finite."""
    dev = src_pos.device
    src, m = src_pos.to(dtype), src_mass.to(dtype)
    tgt = tgt_pos.to(device=dev, dtype=dtype)
    idx = torch.as_tensor(tgt_idx, device=dev)
    k, n = tgt.shape[0], src.shape[0]
    acc = torch.zeros((k, 3), dtype=dtype, device=dev)
    pot = torch.zeros(k, dtype=dtype, device=dev)
    sb = min(SOURCE_BLOCK, n)
    tb = max(1, PASS_BYTES // (8 * 8 * sb))
    eps2 = float(eps) ** 2
    for t0 in range(0, k, tb):
        t = tgt[t0:t0 + tb]
        ti = idx[t0:t0 + tb, None]
        for s0 in range(0, n, sb):
            d = src[None, s0:s0 + sb] - t[:, None]
            r2 = (d * d).sum(-1) + eps2
            out = (ti == torch.arange(s0, s0 + d.shape[1], device=dev)) \
                | (r2 == 0)
            inv_r = torch.where(out, 0.0, r2.rsqrt())
            w = m[None, s0:s0 + sb] * inv_r
            pot[t0:t0 + tb] -= w.sum(1)
            acc[t0:t0 + tb] += torch.einsum("cs,csd->cd", w * inv_r * inv_r,
                                            d)
    return G * acc, G * pot


def probe(pos, mass, cfg, seed: int, eps: float, G: float,
          control_dtype=None) -> float:
    """comp_pot_max: what the accumulation alone costs. A Tree with cfg on
    the first PROBE_N particles of (pos, mass), queried at theta 0, where
    every pair is summed directly: the widest relative potential error at
    PROBE_TARGETS sampled targets against the float64 direct sum. Under
    the control the reference in control_dtype (`lower_sum`) takes the
    Tree's place."""
    from rakau_tpu_torch import octree
    n = min(PROBE_N, pos.shape[0])
    p, m = pos[:n].contiguous(), mass[:n].contiguous()
    samp = torch.as_tensor(inputs.sample(n, PROBE_TARGETS, seed, 4),
                           device=p.device)
    if control_dtype is None:
        tree = octree(coords=p, masses=m, device=p.device, config=cfg)
        got = tree.accs_pots_o(0.0, eps, G)[1][samp]
        del tree
    else:
        got = lower_sum(p, m, p[samp], samp, eps, G, control_dtype)[1]
    _, ref = direct_sum(p, m, p[samp], samp, eps, G)
    return float(((got.double() - ref).abs() / ref.abs()).max())


class Driver(entries.Entry):
    """`Tree.update_positions_o` then `Tree.accs_pots_o` on a tree built
    at set-up on the drawn set P: call k hands the tree, in the caller's
    order, X = P + D for even k (set-up's calls counted) and X = P for odd
    k, D = traffic["drift"] x N(0, 1) from the seed's own stream, so that
    every update re-sorts a near-sorted input into a new permutation. The
    warm-up takes an even number of calls, so that the window opens on
    P + D after a call on P whatever the clock let the warm-up run. Each
    call keeps the answers and `tree.positions_o` at the sampled targets.
    The judgement's checks are those the limits file names, of
    answer_max, answer_rms (the widest and the RMS over the targets of a
    call's answer error, the worst call), order_bad and comp_pot_max (the
    precision probe, `probe`, with the TreeConfig the window's tree ran,
    grown caps included); the rest are diagnostics. Under the control,
    `lower_sum` in the control's precision takes the program's place in
    the calls' answers and in the probe."""

    def particles(self):
        spec = dict(self.config["particles"])
        dist = DISTRIBUTIONS[spec.pop("distribution")]
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return dist(self.n, gen, **spec)

    def drift(self):
        """D [n, 3]: traffic["drift"] x N(0, 1), of the seed's own
        stream."""
        gen = torch.Generator(device=self.device).manual_seed(
            stream_seed(self.seed, 3))
        return self.traffic["drift"] * torch.randn(
            self.n, 3, generator=gen, device=self.device)

    def setup(self):
        from rakau_tpu_torch import engine, octree
        self.pos, self.mass = self.particles()
        self.shift = self.drift()
        self.samp = torch.as_tensor(inputs.sample(
            self.n, self.limits["targets"], self.seed, 1), device=self.device)
        self.turn = 0
        self.update_s = []
        self.tree = octree(coords=self.pos, masses=self.mass,
                           device=self.device, config=self.cfg)
        self.warm()
        td = self.tree.tree_data
        cfg = self.tree.config
        self.info.update(caps_grown=entries.grown(self.cfg0, cfg),
                         n_tiles=int(td.n_tiles),
                         live_chunks=engine.live_chunks(td, cfg),
                         maxima=getattr(self.tree, "_last_stats", None),
                         warm_update_s=self.update_s)
        self.update_s = []

    def warm(self):
        super().warm()
        if self.turn % 2:
            self.call()
            self.info["warm_call_s"] += self.call_s
            self.call_s, self.calls = [], 0
            self.records.clear()

    def positions(self, drifted: bool):
        return self.pos + self.shift if drifted else self.pos

    def _call(self):
        drifted = self.turn % 2 == 0
        self.turn += 1
        t = time.perf_counter()
        self.tree.update_positions_o(self.positions(drifted))
        # the update ends in the build's overflow read: on the host's clock
        self.update_s.append(time.perf_counter() - t)
        # an overflowed cap is grown and the query run again by the Tree:
        # no call returns truncated sums
        acc, pot = self.tree.accs_pots_o(self.theta, self.eps, self.G)
        self.records.append((drifted, acc[self.samp], pot[self.samp],
                             self.tree.positions_o[self.samp]))

    def judge(self) -> tuple:
        cfg = self.tree.config
        self.tree = None
        self.free()
        samp = self.samp
        sets = {}
        for drifted in sorted({r[0] for r in self.records}):
            x = self.positions(drifted)
            tgt = (x, self.mass, x[samp], samp, self.eps, self.G)
            ctl = (None if self.control_dtype is None else
                   lower_sum(*tgt, dtype=self.control_dtype))
            sets[drifted] = (x[samp], direct_sum(*tgt), ctl)
            del x, tgt
        per, bad = [], 0
        for drifted, acc, pot, x_o in self.records:
            x_s, ref, ctl = sets[drifted]
            # the composed permutation: the positions the tree hands back
            # in the caller's order are the caller's, bit for bit
            bad += int(not torch.equal(x_o, x_s))
            per.append(compare.answers(*(ctl or (acc, pot)), *ref))
        # the limits file names the checks of the cell
        wanted = self.limits["checks"]
        checks = {"answer_max": max(r["answer_max"] for r in per),
                  "answer_rms": max(r["answer_rms"] for r in per),
                  "order_bad": float(bad)}
        if "comp_pot_max" in wanted:
            checks["comp_pot_max"] = probe(self.pos, self.mass, cfg,
                                           self.seed, self.eps, self.G,
                                           self.control_dtype)
        diagnostics = {k: checks.pop(k) for k in list(checks)
                       if k not in wanted}
        return checks, dict(diagnostics, force_err_rms=per[-1]["force_rms"],
                            pot_rms=per[-1]["pot_rms"],
                            calls_judged=len(per), sets_judged=len(sets),
                            update_s=self.update_s)
