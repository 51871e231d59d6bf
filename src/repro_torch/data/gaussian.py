"""Gaussian random-field samples (paper section 2.3.2).

2-D stationary Gaussian samples with squared-exponential correlation
Sigma(xi, xj) = sigma^2 exp(-|xi-xj|^2 / a^2), synthesized spectrally:
white noise is shaped in the Fourier domain by the square root of the
power spectrum of the SE kernel (circulant embedding on the periodic
torus -- exact for ranges << domain).

Four sample types, from simplest to most complex (X = sum_l w_l U_l):
  1. single correlation range (L=1)
  2. L=3, scalar weights, fixed ranges
  3. L=3, spatial Gaussian-bump weights, fixed ranges
  4. L=3, spatial weights, random ranges

The random numbers come from a *draws* object, consumed in the
reference's order: :class:`TorchDraws` (an explicit ``torch.Generator``
on the requested device, the default) or :class:`ArrayDraws` (given
arrays, replayed in turn).  ``jax.random`` draws other bits from the
same seed, so parity with the reference is statistical; fed the
reference's own draws, the shaping (:func:`grf_from_noise`,
:func:`spatial_weight_at`) gives its fields up to FFT rounding.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

DEFAULT_SIZE = 1028  # the paper's 1028 x 1028


class TorchDraws:
    """Standard normals and uniforms from a ``torch.Generator``."""

    def __init__(self, gen: torch.Generator, device="cuda"):
        self.gen = gen
        self.device = device

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return lo + u * (hi - lo)


class ArrayDraws:
    """Replays given float32 arrays, in order, as the draws (each call
    takes the next array whatever the shape and bounds asked for)."""

    def __init__(self, arrays, device="cpu"):
        self._arrays = list(arrays)
        self.device = device

    def _next(self) -> torch.Tensor:
        return torch.tensor(self._arrays.pop(0), dtype=torch.float32,
                            device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return self._next()

    def uniform(self, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return self._next()


def _se_spectrum(n: int, a, device) -> torch.Tensor:
    """Power spectrum of the squared-exponential kernel on an n x n torus:
    exp(-(pi a / n)^2 |w|^2) on the integer frequency grid."""
    freq = torch.fft.fftfreq(n, device=device) * n
    w2 = freq[:, None] ** 2 + freq[None, :] ** 2
    return torch.exp(-(math.pi * a / n) ** 2 * w2)


def grf_from_noise(noise_re: torch.Tensor, noise_im: torch.Tensor,
                   a) -> torch.Tensor:
    """The n x n unit-variance field of range ``a`` shaped from given
    (n, n) real and imaginary white noise."""
    n = noise_re.shape[0]
    spec = _se_spectrum(n, a, noise_re.device)
    field = torch.fft.ifft2(torch.complex(noise_re, noise_im)
                            * torch.sqrt(spec)).real
    return field * (n / torch.sqrt(torch.clamp(spec.sum(), min=1e-30)))


def grf_sample(draws, n: int, a) -> torch.Tensor:
    """One n x n sample with SE correlation range ``a`` (unit variance)."""
    re = draws.normal((n, n))
    im = draws.normal((n, n))
    return grf_from_noise(re, im, a)


def spatial_weight_at(mu: torch.Tensor, n: int) -> torch.Tensor:
    """2-D Gaussian-bump weight in [0, 1] centred at ``mu`` (2,), spread
    0.15 n."""
    omega = (0.15 * n) ** 2
    ii = torch.arange(n, dtype=torch.float32, device=mu.device)
    return torch.exp(-((ii[:, None] - mu[0]) ** 2 + (ii[None, :] - mu[1]) ** 2)
                     / (2 * omega))


def _spatial_weight(draws, n: int) -> torch.Tensor:
    """A bump weight with a random centre in [0.2 n, 0.8 n)^2."""
    return spatial_weight_at(draws.uniform((2,), 0.2 * n, 0.8 * n), n)


def sample_type1(draws, n: int = DEFAULT_SIZE, a: float = 32.0) -> torch.Tensor:
    return grf_sample(draws, n, a)


def sample_type2(draws, n: int = DEFAULT_SIZE,
                 ranges: Sequence[float] = (8.0, 32.0, 128.0),
                 weights: Sequence[float] = (0.6, 0.9, 1.2)) -> torch.Tensor:
    out = 0
    for a, w in zip(ranges, weights):
        out = out + w * grf_sample(draws, n, a)
    return out


def sample_type3(draws, n: int = DEFAULT_SIZE,
                 ranges: Sequence[float] = (8.0, 32.0, 128.0)) -> torch.Tensor:
    out = 0
    for a in ranges:
        u = grf_sample(draws, n, a)
        out = out + _spatial_weight(draws, n) * u
    return out


def sample_type4(draws, n: int = DEFAULT_SIZE) -> torch.Tensor:
    # mixture of short / medium / long ranges, drawn randomly
    u = draws.uniform((3,))
    los = torch.tensor([4.0, 16.0, 64.0], device=u.device)
    his = torch.tensor([16.0, 64.0, 256.0], device=u.device)
    ranges = los + u * (his - los)
    out = 0
    for i in range(3):
        f = grf_sample(draws, n, ranges[i])
        out = out + _spatial_weight(draws, n) * f
    return out


SAMPLERS = {1: sample_type1, 2: sample_type2, 3: sample_type3, 4: sample_type4}


def sample_batch(sample_type: int, count: int, n: int = DEFAULT_SIZE,
                 seed: int = 0, device="cuda", draws=None, **kw) -> torch.Tensor:
    """(count, n, n) float32 stack of independent samples of a type, made
    on ``device`` from ``seed`` (or from ``draws``, one object for the
    whole stack).

    For type 1 the correlation range sweeps 4 .. 128 across the samples
    (the paper's type-1 set varies ``a``, which widens its CR range)."""
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draws = TorchDraws(gen, device)
    outs = []
    for i in range(count):
        if sample_type == 1 and "a" not in kw:
            a = 4.0 * (2.0 ** (5.0 * i / max(count - 1, 1)))
            outs.append(sample_type1(draws, n, a))
        else:
            outs.append(SAMPLERS[sample_type](draws, n, **kw))
    return torch.stack(outs).to(torch.float32)
