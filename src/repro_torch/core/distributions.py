"""Input-data distributions of the ADC requirement analysis (paper §IV-A);
the port's counterpart of ``repro.core.distributions``.

i)   Uniform             the INT-CIM baseline; lower-bounds the
                         conventional ADC requirement, upper-bounds the
                         GR-MAC's.
ii)  Maximum entropy     uniformly randomized format bits.
iii) Gaussian + outliers a narrow Gaussian core plus rare uniform
                         high-magnitude outliers (ε = 0.01, k = 50 relative
                         to the core's 3σ).

A sampler takes ``(generator, shape)`` and returns f32 values in [-1, 1]
on the generator's device. ``scale`` shrinks a distribution into the lower
part of the range (the "narrowest valid bounds" of a wide format, §IV-B).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .formats import FPFormat, max_entropy_sample

__all__ = ["Distribution", "uniform", "gaussian_clipped",
           "gaussian_outliers", "max_entropy", "DISTRIBUTIONS"]


@dataclasses.dataclass(frozen=True)
class Distribution:
    """A named sampler: (generator, shape) -> tensor in [-1, 1]."""

    name: str
    sample: Callable[[torch.Generator, tuple], torch.Tensor]

    def __call__(self, generator: torch.Generator,
                 shape: tuple) -> torch.Tensor:
        return self.sample(generator, shape)


def _rand(g, shape):
    return torch.rand(shape, generator=g, device=g.device)


def _randn(g, shape):
    return torch.randn(shape, generator=g, device=g.device)


def uniform(scale: float = 1.0) -> Distribution:
    def _s(g, shape):
        return -scale + _rand(g, shape) * (2.0 * scale)

    return Distribution(f"uniform(x{scale:g})", _s)


def gaussian_clipped(n_sigma: float = 4.0,
                     scale: float = 1.0) -> Distribution:
    """Zero-mean normal clipped to ±n_sigma, full scale at the clip point
    (the Fig. 4 illustration condition)."""
    sigma = scale / n_sigma

    def _s(g, shape):
        return torch.clamp(sigma * _randn(g, shape), -scale, scale)

    return Distribution(f"gauss_clip{n_sigma:g}s", _s)


def gaussian_outliers(eps: float = 0.01, k: float = 50.0,
                      scale: float = 1.0) -> Distribution:
    """Gaussian core + uniform high-magnitude outliers (§IV-A iii): with
    probability ``eps`` a sample is uniform over the full range; the core's
    sigma = scale / (3 k), so the largest outliers just avoid clipping."""
    sigma = scale / (3.0 * k)

    def _s(g, shape):
        core = torch.clamp(sigma * _randn(g, shape), -scale, scale)
        outl = -scale + _rand(g, shape) * (2.0 * scale)
        take = _rand(g, shape) < eps
        return torch.where(take, outl, core)

    return Distribution(f"gauss+outliers(e{eps:g},k{k:g})", _s)


def max_entropy(fmt: FPFormat, scale: float = 1.0) -> Distribution:
    """Uniformly randomized bits of ``fmt``, the quantizer prior
    (§IV-A ii)."""

    def _s(g, shape):
        return scale * max_entropy_sample(g, shape, fmt)

    return Distribution(f"maxent({fmt.name})", _s)


def DISTRIBUTIONS(fmt: Optional[FPFormat] = None) -> dict:
    """The paper's three evaluation distributions, by short name."""
    d = {"uniform": uniform(), "gauss_outliers": gaussian_outliers()}
    if fmt is not None:
        d["max_entropy"] = max_entropy(fmt)
    return d
