"""Floating-point and integer codecs on the normalized interval [-1, +1].

A floating-point scalar is

    x = (-1)^S * M * 2^(E - E_max)

with the *effective* significand ``M`` (normals ``1.m / 2`` in [0.5, 1),
subnormals ``0.m / 2`` in [0, 0.5)) and the *effective* exponent
``E = max(1, E_stored)`` in ``[1, e_max]``, ``e_max = 2**n_exp - 1``.

Plain functions on tensors; shapes are preserved. The grid arithmetic is
exact: powers of two are assembled from IEEE-754 bits (``pow2i``) and
rounding is half-to-even (``torch.round``), so every function here agrees
bit for bit with ``repro.core.formats``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "FPFormat",
    "IntFormat",
    "FP4_E2M1",
    "FP6_E2M3",
    "FP6_E3M2",
    "FP8_E4M3",
    "pow2i",
    "quantize",
    "decompose",
    "compose",
    "int_quantize",
    "quantize_any",
    "parse_format",
    "sqnr_db",
    "measured_sqnr_db",
    "max_entropy_sample",
]

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A sign + ``n_exp`` exponent bits + ``n_man`` stored mantissa bits format."""

    n_exp: int
    n_man: int  # stored mantissa bits, excluding the implicit leading bit

    @property
    def e_max(self) -> int:
        return 2**self.n_exp - 1

    @property
    def bits(self) -> int:
        return 1 + self.n_exp + self.n_man

    @property
    def name(self) -> str:
        return f"FP{self.bits}_E{self.n_exp}M{self.n_man}"

    @property
    def max_value(self) -> float:
        """Largest representable magnitude (< 1)."""
        return 1.0 - 2.0 ** (-self.n_man - 1)

    @property
    def min_normal(self) -> float:
        """Smallest normal magnitude: M=0.5 at E=1."""
        return 2.0 ** (-self.e_max)

    @property
    def min_subnormal(self) -> float:
        """Smallest nonzero magnitude (one subnormal LSB)."""
        return 2.0 ** (-self.n_man - self.e_max)

    @property
    def dr_db(self) -> float:
        """Dynamic range in dB: full-scale over twice the minimum normal."""
        import math

        return 20.0 * math.log10(1.0 / (2.0 * self.min_normal))

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """Signed mid-tread uniform quantizer with ``bits`` total bits on [-1, 1]."""

    bits: int

    @property
    def levels(self) -> int:
        return 2 ** (self.bits - 1) - 1

    @property
    def name(self) -> str:
        return f"INT{self.bits}"


FP4_E2M1 = FPFormat(2, 1)
FP6_E2M3 = FPFormat(2, 3)
FP6_E3M2 = FPFormat(3, 2)
FP8_E4M3 = FPFormat(4, 3)


def parse_format(name: str):
    """Inverse of ``FPFormat.name`` / ``IntFormat.name``: ``"FP6_E3M2"`` or
    ``"INT8"`` back to the format object."""
    if name.startswith("INT"):
        return IntFormat(int(name[3:]))
    try:
        spec = name.split("_", 1)[1]          # "E3M2"
        n_exp, n_man = spec[1:].split("M")
        fmt = FPFormat(int(n_exp), int(n_man))
    except (IndexError, ValueError) as e:
        raise ValueError(f"unparseable format name {name!r}") from e
    if fmt.name != name:
        raise ValueError(f"format name {name!r} does not round-trip "
                         f"(parsed as {fmt.name})")
    return fmt


def pow2i(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**e for integer ``e`` in [-126, 127].

    Built from the IEEE-754 exponent field. ``torch.exp2`` is not exact on
    every backend and ``torch.ldexp`` multiplies by ``pow(2, e)``, so
    neither is used on the grid path.
    """
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _eff_exponent(a: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Effective exponent E in [1, e_max] (int32) of magnitudes ``a``.

    frexp (a = f * 2**e, f in [0.5, 1)) lands powers of two exactly; zero
    and float32 subnormals fall into bin 1.
    """
    _, e = torch.frexp(torch.clamp(a, min=1e-30))
    return torch.clamp(e.to(torch.int32) + fmt.e_max, 1, fmt.e_max)


def quantize(x: torch.Tensor, fmt: FPFormat) -> torch.Tensor:
    """Round-to-nearest-even quantization of ``x`` onto the format grid.

    Saturating: |x| > max_value clamps to max_value.
    """
    a = torch.abs(x)
    e = _eff_exponent(a, fmt)
    lsb = pow2i(e - (fmt.e_max + fmt.n_man + 1)).to(x.dtype)
    q = torch.round(a / lsb) * lsb
    q = torch.clamp(q, max=fmt.max_value)
    return torch.where(x < 0, -q, q)


def decompose(xq: torch.Tensor, fmt: FPFormat):
    """Split (already quantized) values into (sign, M, E) such that
    ``xq == sign * M * 2**(E - e_max)``; E is int32 in [1, e_max]."""
    a = torch.abs(xq)
    e = _eff_exponent(a, fmt)
    m = a * pow2i(fmt.e_max - e).to(xq.dtype)
    sign = torch.where(xq < 0, -1.0, 1.0).to(xq.dtype)
    return sign, m, e


def compose(sign: torch.Tensor, m: torch.Tensor, e: torch.Tensor,
            fmt: FPFormat) -> torch.Tensor:
    return sign * m * pow2i(e - fmt.e_max).to(m.dtype)


def int_quantize(x: torch.Tensor, fmt: IntFormat) -> torch.Tensor:
    lv = fmt.levels
    return torch.round(torch.clamp(x, -1.0, 1.0) * lv) / lv


def quantize_any(x: torch.Tensor, fmt) -> torch.Tensor:
    """Round-to-nearest onto either format family's grid."""
    if isinstance(fmt, IntFormat):
        return int_quantize(x, fmt)
    return quantize(x, fmt)


def sqnr_db(fmt: FPFormat) -> float:
    """Theoretical format SQNR (paper §IV-A): 6.02·N_M + 10.79 dB, with
    ``N_M`` the stored mantissa bits (the implicit leading bit gives the
    +10.79 dB offset against the integer formula). Distribution-independent
    while the data stays in range."""
    return 6.02 * fmt.n_man + 10.79


def measured_sqnr_db(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Empirical signal-to-quantization-noise ratio in dB."""
    p_sig = torch.mean(torch.square(x))
    p_err = torch.mean(torch.square(x - xq))
    return 10.0 * torch.log10(p_sig / torch.clamp(p_err, min=_TINY))


def max_entropy_sample(generator: torch.Generator, shape: tuple,
                       fmt: FPFormat) -> torch.Tensor:
    """Sample the format's maximum-entropy distribution (§IV-A ii): the
    sign, the stored exponent code and the stored mantissa bits are each
    uniform. Drawn by ``generator`` on its own device, f32."""
    kw = dict(generator=generator, device=generator.device)
    sign = torch.where(torch.randint(0, 2, shape, **kw) == 1, 1.0, -1.0)
    e_stored = torch.randint(0, 2**fmt.n_exp, shape, **kw)
    m_bits = torch.randint(0, 2**fmt.n_man, shape, **kw)
    is_normal = (e_stored > 0).to(torch.float32)
    e_eff = torch.clamp(e_stored, min=1)
    m = (is_normal + m_bits.to(torch.float32) / 2**fmt.n_man) / 2.0
    return sign * m * pow2i(e_eff - fmt.e_max)
