"""Weights prepared once for the GR-MAC kernel: ``fmt_w`` codes, packed.

The per-call path (``kernels/ops.py``, as the reference does) recomputes
``sw = max(amax|w|, eps)`` and ``quantize(w / sw, fmt_w)`` on every call,
though both are a pure function of the weights. ``pack_weight`` runs
exactly those operations once and stores the result as format codes:

* a code is ``sign << (bits - 1) | E_stored << n_man | mantissa``, so the
  magnitudes are increasing in the code and ``-0`` keeps its own code;
* formats of at most 4 bits pack two codes a byte (the even K index in the
  low nibble), formats of at most 8 bits one code a byte;
* K is zero-padded (code 0 is +0) to ``k_store``, a multiple of
  ``max(n_r, 32)``, and laid out in 16-byte groups, ``(k_store / group,
  N, 16)`` with ``group`` = 32 codes (4 bits) or 16 (8 bits): a group is
  one column's next ``group`` K rows, and a warp reading 32 neighbouring
  columns of one group reads 512 contiguous bytes.

``unpack_weight`` is the plain version of the kernel's decode: it gathers
each code's value from ``lut`` and gives back the per-call path's
``quantize(w / sw)`` bit for bit, -0 included, zero-padded to ``k_pad``
(a multiple of ``n_r``: the analog columns).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import FPFormat, pow2i, quantize

__all__ = ["EPS", "PackedWeight", "code_values", "pack_weight",
           "pack_quantized", "unpack_weight"]

EPS = 1e-12                     # the pre-scale's floor, as in the reference
N_R_SUPPORTED = (16, 32, 64, 128)


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


@dataclasses.dataclass(frozen=True, eq=False)
class PackedWeight:
    """A (K, N) weight as ``fmt_w`` codes beside its scale ``sw``."""

    codes: torch.Tensor     # uint8 (k_store // group, n, 16)
    sw: torch.Tensor        # 0-d float32: the weight's pre-scale
    lut: torch.Tensor       # float32 (2**bits,): code -> value on the grid
    fmt_w: FPFormat
    k: int                  # logical K
    n: int
    n_r: int

    @property
    def code_bits(self) -> int:
        return 4 if self.fmt_w.bits <= 4 else 8

    @property
    def group(self) -> int:
        """Codes per 16-byte group."""
        return 128 // self.code_bits

    @property
    def k_pad(self) -> int:
        """K rounded up to the analog columns (a multiple of n_r)."""
        return _round_up(self.k, self.n_r)

    @property
    def k_store(self) -> int:
        return self.codes.shape[0] * self.group

    @property
    def shape(self):
        return (self.k, self.n)

    @property
    def device(self) -> torch.device:
        return self.codes.device


def code_values(fmt: FPFormat) -> torch.Tensor:
    """The value of every code of ``fmt`` (float32, 2**bits entries, on the
    CPU), exact: sig * 2^(max(E, 1) - e_max - n_man - 1) with the integer
    significand sig = m (subnormal) or 2^n_man + m (normal)."""
    half = 2 ** (fmt.bits - 1)
    c = torch.arange(half, dtype=torch.int32)
    es = c >> fmt.n_man
    m = c & (2 ** fmt.n_man - 1)
    sub = es == 0
    sig = torch.where(sub, m, m + 2 ** fmt.n_man).to(torch.float32)
    e = torch.where(sub, torch.ones_like(es), es) - fmt.e_max - fmt.n_man - 1
    mags = sig * pow2i(e)
    return torch.cat([mags, -mags])


def _check(fmt: FPFormat, n_r: int) -> None:
    if not isinstance(fmt, FPFormat):
        raise TypeError(f"fmt_w must be an FPFormat, got {fmt!r}")
    if fmt.bits > 8:
        raise ValueError(f"{fmt.name} has {fmt.bits} bits: packed weights "
                         "hold codes of at most 8 bits")
    if n_r not in N_R_SUPPORTED:
        raise ValueError(f"n_r={n_r} not in {N_R_SUPPORTED}")


def pack_quantized(wq: torch.Tensor, sw: torch.Tensor, fmt_w: FPFormat,
                   n_r: int) -> PackedWeight:
    """Encode a (K, N) float32 weight already on the ``fmt_w`` grid, with
    its scale ``sw``. Values off the grid would be encoded wrongly; callers
    pass ``quantize`` output (``pack_weight``) or check (``dispatch``)."""
    _check(fmt_w, n_r)
    if wq.dim() != 2:
        raise ValueError(f"a (K, N) weight expected, got {tuple(wq.shape)}")
    k, n = wq.shape
    bits = fmt_w.bits
    lut = code_values(fmt_w).to(wq.device)
    half = 2 ** (bits - 1)
    mag = torch.searchsorted(lut[:half], wq.abs().contiguous())
    codes = (mag | (torch.signbit(wq).to(mag.dtype) << (bits - 1)))
    codes = codes.to(torch.uint8)
    code_bits = 4 if bits <= 4 else 8
    group = 128 // code_bits
    k_store = _round_up(k, max(n_r, 32))
    codes = torch.nn.functional.pad(codes, (0, 0, 0, k_store - k))
    codes = codes.reshape(k_store // group, group, n).transpose(1, 2)
    if code_bits == 4:
        codes = codes[..., 0::2] | (codes[..., 1::2] << 4)
    return PackedWeight(codes.contiguous(), sw.to(torch.float32).reshape(()),
                        lut, fmt_w, k, n, n_r)


def pack_weight(w: torch.Tensor, fmt_w: FPFormat, n_r: int,
                reduce=None) -> PackedWeight:
    """Prepare a (K, N) weight once: exactly the per-call path's pre-scale
    and quantization, then the codes. Any stride layout (a tied LM head's
    ``embed.T``) gives contiguous codes. ``reduce``, when given, maps the
    absmax of ``w`` to the one ``sw`` is taken from (the max over every
    rank, for a rank that holds an N-chunk of the weight)."""
    _check(fmt_w, n_r)
    w32 = w.to(torch.float32)
    amax = torch.amax(torch.abs(w32))
    sw = torch.clamp(amax if reduce is None else reduce(amax), min=EPS)
    return pack_quantized(quantize(w32 / sw, fmt_w), sw, fmt_w, n_r)


def unpack_weight(p: PackedWeight) -> torch.Tensor:
    """(k_pad, N) float32 values of the codes: the plain version of the
    kernel's in-register decode."""
    c = p.codes
    if p.code_bits == 4:
        c = torch.stack([c & 15, c >> 4], dim=-1).reshape(*c.shape[:2], 32)
    vals = p.lut[c.transpose(1, 2).reshape(p.k_store, p.n).long()]
    return vals[:p.k_pad]
