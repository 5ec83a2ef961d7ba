"""The CIM matmul the model layers call.

``cim_matmul(x, w, cfg, site=...)`` is a matmul over the last dim of
``x``: (..., K) @ (K, N) -> (..., N).

0. per-site policy: ``cfg.for_site(site)`` resolves which design (or
   "off") runs at this call site;
1. dynamic pre-scale: activations are normalized into [-1, 1] by their
   per-tensor absmax (one absmax over the whole flattened activation, so
   every row of a batch shapes every other row's numbers); weights likewise;
2. mode dispatch:
     off        exact matmul (digital baseline)
     fakequant  format-grid quantization of x and w, exact accumulation
     grmac      the GR-MAC block simulation through ``kernels.dispatch``
3. straight-through gradients: the backward applies the exact-matmul
   gradient to the *raw* saved operands, so the op is trainable and its
   backward is digital.

``site`` and ``logical_n`` are kept for the energy ledger, which is not
ported yet (the LM head records the true ``vocab_size`` there); neither
changes the numbers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.formats import IntFormat, quantize, quantize_any

from .dispatch import grmac_matmul, resolve_backend

__all__ = ["cim_matmul"]

_EPS = 1e-12


def _cim_matmul_2d(x: torch.Tensor, w: torch.Tensor, cfg: CIMConfig,
                   backend: str) -> torch.Tensor:
    """(M, K) @ (K, N) with CIM numerics (forward only)."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    w32 = w.to(torch.float32)
    sx = torch.clamp(torch.amax(torch.abs(x32)), min=_EPS)
    sw = torch.clamp(torch.amax(torch.abs(w32)), min=_EPS)
    xn = x32 / sx
    wn = w32 / sw
    if cfg.mode == "fakequant":
        out = quantize_any(xn, cfg.fmt_x) @ quantize(wn, cfg.fmt_w)
    elif cfg.mode == "grmac":
        if isinstance(cfg.fmt_x, IntFormat):
            raise NotImplementedError(
                "grmac execution with an IntFormat input is not "
                "implemented (the gr_int signal chain has no kernel): "
                "deploy INT designs with mode='fakequant', or pick an FP "
                "format")
        out = grmac_matmul(
            xn,
            quantize(wn, cfg.fmt_w),
            fmt_x=cfg.fmt_x,
            fmt_w=cfg.fmt_w,
            n_r=cfg.n_r,
            enob=cfg.resolved_enob(),
            granularity=cfg.granularity,
            backend=backend,
        )
    else:  # off
        out = xn @ wn
    return (out * (sx * sw)).to(dtype)


class _CimMatmulSTE(torch.autograd.Function):
    """CIM forward, straight-through (exact-matmul) backward."""

    @staticmethod
    def forward(ctx, x, w, cfg, backend):
        ctx.save_for_backward(x, w)
        return _cim_matmul_2d(x, w, cfg, backend)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (g @ w.T.to(g.dtype)).to(x.dtype)
        gw = (x.T.to(g.dtype) @ g).to(w.dtype)
        return gx, gw, None, None


def cim_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: Optional[CIMConfig] = None,
    *,
    site: Optional[str] = None,
    backend: Optional[str] = None,
    logical_n: Optional[int] = None,
) -> torch.Tensor:
    """(..., K) @ (K, N) with CIM numerics per ``cfg.for_site(site)``
    (None/off = exact digital matmul).

    ``site=None`` treats ``cfg`` as already resolved. Backend precedence:
    ``backend=`` argument > ``cfg.backend``.
    """
    del logical_n  # ledger metadata; the matmul runs at the physical shape
    eff = cfg.for_site(site) if cfg is not None else None
    if eff is None or not eff.enabled:
        return x @ w
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    backend = resolve_backend(backend or eff.backend)
    out = _CimMatmulSTE.apply(x.reshape(math.prod(lead), k), w, eff, backend)
    return out.reshape(*lead, n)
