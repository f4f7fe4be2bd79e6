"""Box handling, discretization, API-boundary validation and the sample
generators (Plummer, uniform cube, cold sphere, disk galaxy).
Counterpart of `rakau_tpu.particles`.

The domain box is centred on the origin. Validation runs once at the API
boundary (one host read, `read.valid`), never inside the query.
"""
from __future__ import annotations

import math

import torch

from .utils.timing import read


def auto_box_size(pos: torch.Tensor) -> torch.Tensor:
    """Smallest origin-centred box holding every position, with a 1e-4
    margin (0-dim tensor of pos.dtype)."""
    m = pos.abs().max()
    m = torch.where(m > 0, m, torch.ones_like(m))
    return 2.0 * m * torch.full((), 1.0 + 1e-4, dtype=pos.dtype,
                                device=pos.device)


def scalar_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """x (a number or a tensor: a box size, a time step) as a 0-dim tensor
    of like.dtype on like.device. A number is filled in on the device (no
    host-to-device copy, which a CUDA graph capture refuses), rounded once
    to the dtype as torch.as_tensor rounds it: one ulp of the box moves
    Morton codes (discretize)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def validate(pos: torch.Tensor, mass: torch.Tensor,
             box_size) -> torch.Tensor:
    """Violation flags [3] bool: non-finite coordinates, non-finite
    masses, coordinates outside the box (mismatched lengths are the
    caller's host check)."""
    half = scalar_tensor(box_size, pos) / 2
    return torch.stack([(~torch.isfinite(pos)).any(),
                        (~torch.isfinite(mass)).any(),
                        (pos.abs() >= half).any()])


def raise_on_invalid(pos: torch.Tensor, mass: torch.Tensor, box_size):
    """Raise ValueError on mismatched lengths (read on the host), or on any
    flag of validate (one device read, `read.valid`)."""
    if pos.shape[0] != mass.shape[0]:
        raise ValueError(
            f"positions ({pos.shape[0]}) and masses ({mass.shape[0]}) "
            "must have the same length")
    nonfinite_pos, nonfinite_mass, out_of_box = read(
        validate(pos, mass, box_size), "valid").tolist()
    if nonfinite_pos:
        raise ValueError("non-finite coordinate detected")
    if nonfinite_mass:
        raise ValueError("non-finite mass detected")
    if out_of_box:
        raise ValueError(
            "coordinate outside the origin-centered box of size "
            f"{float(box_size)} detected")


def discretize(pos: torch.Tensor, box_size, depth: int) -> torch.Tensor:
    """[N, ndim] float in [-box/2, box/2) -> [N, ndim] int64 cells in
    [0, 2**depth).

    The operation order `(pos + half) / box * ncells`, then floor and
    clamp, is that of the reference: one ulp of difference would move a
    particle across a cell face and change its Morton code."""
    ncells = float(2 ** depth)
    box = scalar_tensor(box_size, pos)
    half = box / 2
    u = (pos + half) / box
    c = torch.floor(u * torch.full((), ncells, dtype=pos.dtype,
                                   device=pos.device))
    c = torch.clamp(c, 0.0, ncells - 1.0)
    return c.to(torch.int64)


def cell_center(cells: torch.Tensor, box_size: torch.Tensor, depth: int,
                level) -> torch.Tensor:
    """Geometric centre of the level-`level` cell holding each entry.

    cells: [N, ndim] int64 at full `depth` resolution; level: int or [N]
    int64 tensor."""
    if not isinstance(level, torch.Tensor):
        # filled in on the device: no host-to-device copy of a number
        level = torch.full((), level, dtype=torch.int64, device=cells.device)
    shift = (depth - level).to(torch.int64)
    lv = level.to(box_size.dtype)
    if shift.ndim:
        shift = shift[:, None]
        lv = lv[:, None]
    coarse = (cells >> shift).to(box_size.dtype)
    cell_sz = box_size * torch.exp2(-lv)
    return (coarse + 0.5) * cell_sz - box_size / 2


def plummer(n: int, *, generator: torch.Generator, ndim: int = 3,
            dtype: torch.dtype = torch.float32, a: float = 1.0,
            clip_radius: float = 10.0):
    """Plummer-sphere sample of n equal-mass particles (total mass 1) on
    the generator's device. Same distribution as
    `rakau_tpu.particles.plummer`; the draws differ."""
    dev = generator.device
    u = torch.rand(n, generator=generator, device=dev,
                   dtype=torch.float32) * (1.0 - 2e-6) + 1e-6
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    r = torch.clamp(r, max=clip_radius * a)
    vec = torch.randn(n, ndim, generator=generator, device=dev,
                      dtype=torch.float32)
    vec = vec / torch.linalg.norm(vec, dim=1, keepdim=True)
    pos = (vec * r[:, None]).to(dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    return pos, mass


def uniform_cube(n: int, *, generator: torch.Generator, ndim: int = 3,
                 dtype: torch.dtype = torch.float32, box: float = 1.0):
    """n equal-mass particles (total mass 1) uniform in the cube of side
    0.999 * box centred on the origin (benchmark config #1)."""
    dev = generator.device
    half = box / 2 * 0.999
    u = torch.rand(n, ndim, generator=generator, device=dev,
                   dtype=torch.float32)
    pos = (u * (2 * half) - half).to(dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    return pos, mass


def cold_sphere(n: int, *, generator: torch.Generator, ndim: int = 3,
                dtype: torch.dtype = torch.float32, radius: float = 1.0):
    """Uniform-density sphere of n equal-mass particles (total mass 1),
    the cold collapse of benchmark config #2."""
    dev = generator.device
    vec = torch.randn(n, ndim, generator=generator, device=dev,
                      dtype=torch.float32)
    vec = vec / torch.linalg.norm(vec, dim=1, keepdim=True)
    r = radius * torch.rand(n, generator=generator, device=dev,
                            dtype=torch.float32) ** (1.0 / ndim)
    pos = (vec * r[:, None]).to(dtype)
    mass = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    return pos, mass


def disk_galaxy(n: int, *, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, rscale: float = 1.0,
                zscale: float = 0.05):
    """Exponential disk of n equal-mass particles (total mass 1), 3-D
    (benchmark config #3): radius from the gamma(2) inverse CDF as a sum
    of two exponentials, cut at 20 rscale; uniform azimuth; Gaussian
    height of scale zscale."""
    dev = generator.device

    def u01():
        return torch.rand(n, generator=generator, device=dev,
                          dtype=torch.float32) * (1.0 - 2e-6) + 1e-6
    r = -rscale * (torch.log(u01()) + torch.log(u01()))
    r = torch.clamp(r, max=20.0 * rscale)
    phi = torch.rand(n, generator=generator, device=dev,
                     dtype=torch.float32) * (2 * math.pi)
    z = zscale * torch.randn(n, generator=generator, device=dev,
                             dtype=torch.float32)
    pos = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=1)
    mass = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    return pos.to(dtype), mass
