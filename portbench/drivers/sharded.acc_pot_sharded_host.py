"""The driver of `parallel.sharded.acc_pot_sharded_host`: a closed loop of
sharded queries over a mesh of a shard a card."""
from __future__ import annotations

import torch

from portbench import entries, inputs


class Driver(entries.Entry):
    """`parallel.sharded.acc_pot_sharded_host` over a mesh of
    config["shards"] shards, a shard a card: card 0 builds the tree of all
    N, each card evaluates its range of the chunks, card 0 gathers and
    assembles. Inputs and outputs live on card 0."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.shards = self.config["shards"]

    @property
    def cards(self) -> list:
        if self.device.type != "cuda":
            return [None]
        return sorted({d.index for d in self.mesh.devices})

    def setup(self):
        from rakau_tpu_torch.parallel import sharded
        self.mesh = (sharded.default_mesh(self.shards)
                     if self.device.type == "cuda" else
                     sharded.default_mesh(self.shards, device="cpu"))
        self.device = self.mesh.devices[0]
        self.pos, self.mass = self.particles()
        self.samp = torch.as_tensor(inputs.sample(
            self.n, self.limits["targets"], self.seed, 1), device=self.device)
        self.warm()

    def call(self):
        from rakau_tpu_torch.parallel import mesh
        mesh.reset_copied()
        super().call()
        self.copied_bytes = sum(mesh.copied.values())

    def _call(self):
        from rakau_tpu_torch.parallel import sharded
        acc, pot, ovf = sharded.acc_pot_sharded_host(
            self.pos, self.mass, self.cfg, self.theta, self.eps, self.G,
            self.mesh)
        self.records.append((acc[self.samp], pot[self.samp], ovf))

    def failed(self) -> int:
        return sum(bool(r[2].any()) for r in self.records)

    def judge(self) -> tuple:
        self.pos = self.mass = None
        self.free()
        return entries.judge_answers(self, [r[:2] for r in self.records])
