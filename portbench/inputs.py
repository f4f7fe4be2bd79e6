"""The benchmark's own inputs: particle sets and target samples, made from
the run's seed and handed alike to the program and to the reference.

The distributions are frozen copies of the formulae that BASELINE's
configurations name (benchmarks/configs.py: a Plummer sphere, the cold
uniform sphere of config #2, the uniform cube of configs #1 and #4), drawn
on the device by one torch.Generator in a few large calls. Nothing here
reads the program."""
from __future__ import annotations

import numpy as np
import torch


def plummer(n: int, gen: torch.Generator, a: float = 1.0,
            clip_radius: float = 10.0):
    """n equal-mass particles (total mass 1) of a Plummer sphere of scale
    a, radii cut at clip_radius * a."""
    dev = gen.device
    u = torch.rand(n, generator=gen, device=dev) * (1.0 - 2e-6) + 1e-6
    r = torch.clamp(a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0),
                    max=clip_radius * a)
    vec = torch.randn(n, 3, generator=gen, device=dev)
    pos = vec / torch.linalg.norm(vec, dim=1, keepdim=True) * r[:, None]
    return pos, torch.full((n,), 1.0 / n, device=dev)


def cold_sphere(n: int, gen: torch.Generator, radius: float = 1.0):
    """n equal-mass particles (total mass 1) uniform in a sphere: the
    cold collapse of BASELINE config #2."""
    dev = gen.device
    vec = torch.randn(n, 3, generator=gen, device=dev)
    r = radius * torch.rand(n, generator=gen, device=dev) ** (1.0 / 3.0)
    pos = vec / torch.linalg.norm(vec, dim=1, keepdim=True) * r[:, None]
    return pos, torch.full((n,), 1.0 / n, device=dev)


def uniform_cube(n: int, gen: torch.Generator, box: float = 1.0):
    """n equal-mass particles (total mass 1) uniform in the cube of side
    0.999 * box about the origin (BASELINE configs #1 and #4)."""
    dev = gen.device
    half = box / 2 * 0.999
    pos = torch.rand(n, 3, generator=gen, device=dev) * (2 * half) - half
    return pos, torch.full((n,), 1.0 / n, device=dev)


DISTRIBUTIONS = {"plummer": plummer, "cold_sphere": cold_sphere,
                 "uniform_cube": uniform_cube}


def particles(config: dict, seed: int, device, n: int):
    """(pos [n, 3], mass [n]) float32 on `device`, of the configuration's
    distribution ("particles": {"distribution": name, and its keyword
    arguments}), from `seed`."""
    spec = dict(config["particles"])
    dist = DISTRIBUTIONS[spec.pop("distribution")]
    gen = torch.Generator(device=device).manual_seed(seed)
    return dist(n, gen, **spec)


def sample(n: int, k: int, seed: int, stream: int) -> np.ndarray:
    """k distinct indices of range(n), sorted, drawn from (seed, stream)."""
    rng = np.random.default_rng([seed, stream])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
