"""Synthetic stand-ins for the paper's scientific datasets.

The same generators as the reference: miranda, cesm-cloud, hurricane,
nyx and qmcpack on the power-law spectrum field, ``scale-*`` on the
Gaussian random fields of ``data.gaussian``.  Fields are made with
``torch.fft`` from a draws object (``gaussian.TorchDraws``: an explicit
``torch.Generator`` on the requested device), so a full-size stack is
generated where it is used.  The random numbers are not the reference's
(``jax.random`` draws other bits from the same seed): parity with the
reference is statistical, and parity tests feed a generator the
reference's own draws (``gaussian.ArrayDraws``) or hand both packages
the same arrays.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Callable, Dict

import torch

from repro_torch.data import gaussian


def _fbm_spectrum_field(draws, n: int, slope: float,
                        device) -> torch.Tensor:
    """Power-law (turbulence-like) random field: |k|^-slope spectrum."""
    freq = torch.fft.fftfreq(n, device=device) * n
    k2 = freq[:, None] ** 2 + freq[None, :] ** 2
    spec = torch.where(k2 > 0, k2.clamp(min=1.0) ** (-slope / 2.0),
                       torch.zeros_like(k2))
    re = draws.normal((n, n))
    im = draws.normal((n, n))
    f = torch.fft.ifft2(torch.complex(re, im) * torch.sqrt(spec)).real
    return f / torch.clamp(torch.std(f, correction=0), min=1e-9)


def _grid(n: int, lo: float, hi: float, device):
    ii = torch.linspace(lo, hi, n, device=device)
    return torch.meshgrid(ii, ii, indexing="ij")


def miranda_like(draws, n: int = 384, z: float = 0.0, device="cuda") -> torch.Tensor:
    """Multicomponent-flow density: smooth turbulence + sharp material
    interface (tanh front) whose position drifts with slice index z."""
    mix = 0.5 - 0.5 * math.cos(z)
    turb = _fbm_spectrum_field(draws, n, 4.0 - 1.8 * mix, device)
    ii = torch.linspace(-1, 1, n, device=device)
    front = torch.tanh((ii[:, None] - 0.3 * math.sin(3 * z)
                        + (0.05 + 0.4 * mix) * turb) * (2.0 + 12.0 * mix))
    return (1.5 + 0.5 * front + (0.05 + 0.45 * mix) * turb).to(torch.float32)


def cesm_cloud_like(draws, n: int = 512, z: float = 0.0, device="cuda") -> torch.Tensor:
    """Cloud fraction: intermittent [0,1] field with large clear patches."""
    mix = 0.5 - 0.5 * math.cos(z)
    base = _fbm_spectrum_field(draws, n, 3.4 - 1.6 * mix, device)
    sharp = 2.0 + 10.0 * mix
    cloud = torch.sigmoid((base - 0.4 + 0.3 * math.cos(2 * z)) * sharp)
    return torch.clamp(cloud, 0.0, 1.0).to(torch.float32)


def hurricane_like(draws, n: int = 500, z: float = 0.0, device="cuda") -> torch.Tensor:
    """East-west wind with a vortex: solid-body core + 1/r tail + noise."""
    x, y = _grid(n, -1.0, 1.0, device)
    cx, cy = 0.25 * math.sin(z), 0.25 * math.cos(z)
    r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2) + 1e-3
    vtheta = torch.where(r < 0.2, r / 0.2, 0.2 / r) * 40.0
    u = -vtheta * (y - cy) / r
    mix = 0.5 - 0.5 * math.cos(z)
    noise = (0.5 + 6.0 * mix) * _fbm_spectrum_field(draws, n, 3.6 - 1.4 * mix,
                                                    device)
    return (u + noise).to(torch.float32)


def scale_letkf_like(draws, n: int = 600, z: float = 0.0, device="cuda") -> torch.Tensor:
    """Rainfall-simulation wind: strong multiscale heterogeneity (the
    paper's hardest 2-D case) -- mixed small/large-scale features."""
    mix = 0.5 - 0.5 * math.cos(z)
    large = gaussian.grf_sample(draws, n, 96.0)
    small = gaussian.grf_sample(draws, n, 4.0 + 12.0 * (1 - mix))
    w = gaussian._spatial_weight(draws, n)
    return (10.0 * large + (1.0 + 7.0 * mix) * w * small
            + 3.0 * mix * small * large).to(torch.float32)


def nyx_like(draws, n: int = 512, z: float = 0.0, device="cuda") -> torch.Tensor:
    """Cosmology baryon velocity: filamentary, heavy-tailed."""
    mix = 0.5 - 0.5 * math.cos(z)
    base = _fbm_spectrum_field(draws, n, 3.2 - 1.2 * mix, device)
    fil = _fbm_spectrum_field(draws, n, 3.5, device)
    return (1e6 * torch.tanh(base) * (1.0 + (0.1 + mix) * torch.abs(fil))
            ).to(torch.float32)


def qmcpack_like(draws, n: int = 96, z: float = 0.0, device="cuda") -> torch.Tensor:
    """Electronic orbital: smooth oscillatory standing waves + envelope."""
    x, y = _grid(n, 0.0, 1.0, device)
    mix = 0.5 - 0.5 * math.cos(z)
    kx, ky = 4 + 14 * mix, 5 + 11 * mix
    wave = torch.sin(2 * math.pi * kx * x) * torch.sin(2 * math.pi * ky * y)
    env = torch.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) * 6.0)
    noise = (0.01 + 0.15 * mix) * _fbm_spectrum_field(draws, n, 3.0, device)
    return (wave * env + noise).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    generator: Callable
    n: int                 # slice edge (reduced-size default)
    full_n: int            # paper's slice edge (Table 1)
    slices: int            # number of 2-D slices available
    eps: float             # the paper's error bound for this field


FIELDS: Dict[str, FieldSpec] = {
    "miranda-vx":   FieldSpec("miranda-vx", miranda_like, 384, 384, 64, 1e-5),
    "miranda-de":   FieldSpec("miranda-de", miranda_like, 384, 384, 64, 1e-5),
    "cesm-cloud":   FieldSpec("cesm-cloud", cesm_cloud_like, 512, 1800, 48, 1e-5),
    "hurricane-u":  FieldSpec("hurricane-u", hurricane_like, 500, 500, 48, 1e-2),
    "scale-u":      FieldSpec("scale-u", scale_letkf_like, 600, 1200, 48, 1e-3),
    "scale-pressure": FieldSpec("scale-pressure", scale_letkf_like, 600, 1200, 48, 1e-3),
    "nyx-vx":       FieldSpec("nyx-vx", nyx_like, 512, 512, 48, 1e-2),
    "qmcpack":      FieldSpec("qmcpack", qmcpack_like, 96, 96, 64, 1e-2),
}


def field_slices(name: str, count: int | None = None, seed: int = 0,
                 n: int | None = None, device="cuda") -> torch.Tensor:
    """(count, n, n) float32 stack of 2-D slices of a named field, made
    on ``device`` from ``seed``; the structure parameter z sweeps
    [0, pi] along the stack as in the reference."""
    spec = FIELDS[name]
    count = count or spec.slices
    n = n or spec.n
    gen = torch.Generator(device=device)
    gen.manual_seed(zlib.crc32(name.encode()) % (2 ** 31) + seed)
    draws = gaussian.TorchDraws(gen, device)
    zs = torch.linspace(0.0, math.pi, count, dtype=torch.float64).tolist()
    return torch.stack([spec.generator(draws, n, zs[i], device=device)
                        for i in range(count)])


def volume(name: str, shape=(64, 96, 96), seed: int = 0, device="cuda",
           draws=None) -> torch.Tensor:
    """A (d, m, n) float32 volume of smoothly varying slabs (the HOSVD /
    TTHRESH experiments, paper section 4.5).

    As in the reference, every slab is made from the same random draws
    (the generator is re-seeded before each), so slabs differ only
    through the structure parameter z, which sweeps [0, pi] along d:
    the volume is smooth along its first axis.  Slabs are made at
    ``max(shape[1:])`` and cropped to ``shape``.  ``draws``, if given,
    is a callable returning a fresh draws object for each slab."""
    spec = FIELDS[name]
    d, n = shape[0], max(shape[1:])
    seed = zlib.crc32(name.encode()) % (2 ** 31) + 7 + seed

    def fresh():
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return gaussian.TorchDraws(gen, device)

    zs = torch.linspace(0.0, math.pi, d, dtype=torch.float64).tolist()
    slabs = [spec.generator((draws or fresh)(), n, z, device=device)
             for z in zs]
    return torch.stack(slabs)[:, :shape[1], :shape[2]].contiguous()
