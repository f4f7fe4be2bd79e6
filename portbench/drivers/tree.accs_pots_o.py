"""The driver of `Tree.accs_pots_o`: a closed loop of queries on a tree
built at set-up."""
from __future__ import annotations

import torch

from portbench import entries, inputs


class Driver(entries.Entry):
    """`Tree.accs_pots_o` on a tree built at set-up: each call evaluates
    every particle's acceleration and potential in the caller's order."""

    def setup(self):
        from rakau_tpu_torch import engine, octree
        pos, mass = self.particles()
        self.samp = torch.as_tensor(inputs.sample(
            self.n, self.limits["targets"], self.seed, 1), device=self.device)
        self.tree = octree(coords=pos, masses=mass, device=self.device,
                           config=self.cfg)
        del pos, mass
        self.warm()
        td = self.tree.tree_data
        cfg = self.tree.config
        self.info.update(caps_grown=entries.grown(self.cfg0, cfg),
                         n_tiles=int(td.n_tiles),
                         live_chunks=engine.live_chunks(td, cfg))

    def _call(self):
        # an overflowed cap is grown and the query run again by the Tree:
        # no call returns truncated sums
        acc, pot = self.tree.accs_pots_o(self.theta, self.eps, self.G)
        self.records.append((acc[self.samp], pot[self.samp]))

    def judge(self) -> tuple:
        self.tree = None
        self.free()
        return entries.judge_answers(self, self.records)
