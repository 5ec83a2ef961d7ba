"""The GR-MAC chain, frozen: format quantization, the row-normalized GR-MAC
matmul and the per-tensor pre-scale of a CIM projection.

Float32 throughout, in the operations and the order that the paper's
signal chain defines (paper §III-C2):

    xq = Q_fmt_x(x / sx), wq = Q_fmt_w(w / sw)   (sx, sw: max |.|, >= 1e-12)
    per K-block of n_r rows:  num = xq_blk @ wq_blk,  den = sum 2^E(xq_blk)
        v = num * 2^e_max / den,  z += Q_ADC(v) * den * 2^-e_max
    out = z * (sx * sw)

The values dot is exact in float32 (a product has at most five
significant bits and a block's sum spans fewer than 24 bits), and so is
the sum of the blocks' terms (each a multiple of 2^-13 below 2^5 in
magnitude) while it stays below 2^11, so neither order matters. Formats
are given by name (``FP6_E3M2``: sign, 3 exponent bits, 2 mantissa
bits).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-12


class Fmt:
    """A sign + ``n_exp`` + ``n_man`` floating-point format on [-1, 1]."""

    def __init__(self, name: str):
        e, m = name.split("_", 1)[1][1:].split("M")
        self.name, self.n_exp, self.n_man = name, int(e), int(m)
        self.e_max = 2 ** self.n_exp - 1
        self.max_value = 1.0 - 2.0 ** (-self.n_man - 1)


def pow2i(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2**e for integer e in [-126, 127], from the bits."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _eff_exponent(a: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    _, e = torch.frexp(torch.clamp(a, min=1e-30))
    return torch.clamp(e.to(torch.int32) + fmt.e_max, 1, fmt.e_max)


def quantize(x: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """Round to nearest even onto the format's grid, saturating."""
    a = torch.abs(x)
    e = _eff_exponent(a, fmt)
    lsb = pow2i(e - (fmt.e_max + fmt.n_man + 1)).to(x.dtype)
    q = torch.round(a / lsb) * lsb
    q = torch.clamp(q, max=fmt.max_value)
    return torch.where(x < 0, -q, q)


def adc_delta(enob: float) -> float:
    """The ADC step 2 / 2**enob in float32."""
    return float(2.0 / torch.exp2(torch.tensor(float(enob),
                                               dtype=torch.float32)))


def grmac_row(xn: torch.Tensor, wq: torch.Tensor, fmt_x: Fmt, n_r: int,
              enob: float) -> torch.Tensor:
    """(M, K) pre-scaled x @ (K, N) quantized weights -> (M, N) float32,
    K a multiple of n_r. Block terms are laid out (K / n_r, M, N)."""
    m, k = xn.shape
    n = wq.shape[1]
    b = k // n_r
    xq = quantize(xn, fmt_x)
    xb = xq.reshape(m, b, n_r).transpose(0, 1)
    wb = wq.reshape(b, n_r, n)
    num = torch.bmm(xb, wb)
    gxb = pow2i(_eff_exponent(torch.abs(xq), fmt_x)).reshape(
        m, b, n_r).transpose(0, 1)
    den = gxb.sum(dim=-1, keepdim=True)
    v = num * 2.0 ** fmt_x.e_max / den
    delta = adc_delta(enob)
    q = torch.clamp(torch.round(v / delta) * delta, -1.0, 1.0)
    z = q * (den * 2.0 ** -fmt_x.e_max)
    return z.sum(dim=0)


class CIM:
    """One model's CIM design (row granularity) from its configuration's
    ``cim`` entry."""

    def __init__(self, cim: dict):
        if cim["mode"] != "grmac" or cim["granularity"] != "row":
            raise ValueError(f"the reference computes GR-MAC row only, "
                             f"got {cim['mode']} / {cim['granularity']}")
        self.fmt_x, self.fmt_w = Fmt(cim["fmt_x"]), Fmt(cim["fmt_w"])
        self.n_r, self.enob = int(cim["n_r"]), float(cim["enob"])

    def prepare(self, w: torch.Tensor):
        """(quantized weight padded to the analog columns, its scale sw)."""
        w32 = w.to(torch.float32)
        sw = torch.clamp(torch.amax(torch.abs(w32)), min=EPS)
        wq = quantize(w32 / sw, self.fmt_w)
        pad = -wq.shape[0] % self.n_r
        return (F.pad(wq, (0, 0, 0, pad)) if pad else wq), sw

    def matmul(self, x: torch.Tensor, prepared) -> torch.Tensor:
        """x (..., K) through the projection: pre-scale by max |x| over the
        whole activation, GR-MAC, post-scale; in x's dtype."""
        wq, sw = prepared
        lead, k = x.shape[:-1], x.shape[-1]
        x32 = x.reshape(-1, k).to(torch.float32)
        sx = torch.clamp(torch.amax(torch.abs(x32)), min=EPS)
        xn = x32 / sx
        pad = -k % self.n_r
        if pad:
            xn = F.pad(xn, (0, pad))
        # rows in blocks, each block's (K / n_r, rows, N) terms under 2**28
        # elements; every term and block sum is exact, so blocks change
        # no bit
        n = wq.shape[1]
        rows = max(1, (1 << 28) // (wq.shape[0] // self.n_r * n))
        out = torch.cat([grmac_row(xn[i:i + rows], wq, self.fmt_x, self.n_r,
                                   self.enob)
                         for i in range(0, xn.shape[0], rows)])
        return (out * (sx * sw)).to(x.dtype).reshape(*lead, n)


class _STE(torch.autograd.Function):
    """GR-MAC forward, exact-matmul (straight-through) backward on the raw
    operands."""

    @staticmethod
    def forward(ctx, x2, w, cim):
        ctx.save_for_backward(x2, w)
        return cim.matmul(x2, cim.prepare(w))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = (g @ w.T.to(g.dtype)).to(x2.dtype)
        gw = (x2.T.to(g.dtype) @ g).to(w.dtype)
        return gx, gw, None


def ste_matmul(x: torch.Tensor, w: torch.Tensor, cim: CIM) -> torch.Tensor:
    """A trainable projection: the weight quantized on every call."""
    lead, k = x.shape[:-1], x.shape[-1]
    out = _STE.apply(x.reshape(-1, k), w.to(x.dtype), cim)
    return out.reshape(*lead, w.shape[-1])
