"""The disk galaxy of BASELINE config #3 (benchmarks/configs.py:147-182),
drawn for the benchmark: a frozen copy of the law of
rakau_tpu_torch.particles.disk_galaxy, drawn on the device by one
torch.Generator as portbench/inputs.py draws its distributions. Nothing
here reads the program."""
from __future__ import annotations

import math

import torch


def disk_galaxy(n: int, gen: torch.Generator, rscale: float = 1.0,
                zscale: float = 0.05):
    """n equal-mass particles (total mass 1) of an exponential disk: the
    radius from the gamma(2) inverse CDF as a sum of two exponentials, cut
    at 20 rscale; a uniform azimuth; a Gaussian height of scale zscale."""
    dev = gen.device

    def u01():
        return torch.rand(n, generator=gen, device=dev) * (1.0 - 2e-6) + 1e-6
    r = -rscale * (torch.log(u01()) + torch.log(u01()))
    r = torch.clamp(r, max=20.0 * rscale)
    phi = torch.rand(n, generator=gen, device=dev) * (2 * math.pi)
    z = zscale * torch.randn(n, generator=gen, device=dev)
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)
    return pos, torch.full((n,), 1.0 / n, device=dev)
