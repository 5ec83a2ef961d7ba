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

``w`` may also be a ``PackedWeight`` (``kernels/packed.py``): the weight's
pre-scale and quantization done once, for serving. Only ``grmac`` sites
take one, and it refuses gradients. On the card every ``grmac`` call goes
to the kernel, which takes x raw and applies the pre-scale (sx from one
absmax reduction) and the post-scale itself; a raw weight is packed on
the way. The plain path (CPU tensors, or ``backend="ref"``) runs the
reference's operations one by one, a packed weight decoded first.

Every call records its contract ``(site, M, K, N)`` under the resolved
design into the active ``core.costs`` ledger (a no-op outside
``costs.recording``); ``logical_n`` is the N recorded where it differs from
the physical one (the LM head's true ``vocab_size``). On a ``meta`` tensor
(the ledger's shape-only trace) the call records and returns an empty
tensor of the output's shape: neither the kernel nor the plain version
runs.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.core import costs
from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.formats import IntFormat, quantize, quantize_any

from .dispatch import grmac_matmul, resolve_backend
from .grmac_matmul import grmac_matmul_cuda
from .packed import EPS as _EPS
from .packed import PackedWeight, pack_weight, unpack_weight

__all__ = ["cim_matmul"]


def _cim_matmul_2d(x: torch.Tensor, w: Union[torch.Tensor, PackedWeight],
                   cfg: CIMConfig, backend: str) -> torch.Tensor:
    """(M, K) @ (K, N) with CIM numerics (forward only)."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    if cfg.mode == "grmac":
        _check_fp_input(cfg)
        on_card = x32.device.type == "cuda" and backend == "auto"
        if on_card or isinstance(w, PackedWeight):
            pw = w if isinstance(w, PackedWeight) \
                else pack_weight(w, cfg.fmt_w, cfg.n_r)
            if on_card:
                # max |x| in one reduction (the kernel clamps it to sx)
                out = grmac_matmul_cuda(
                    x32.contiguous(), pw,
                    torch.linalg.vector_norm(x32, float("inf")),
                    fmt_x=cfg.fmt_x, enob=cfg.resolved_enob(),
                    granularity=cfg.granularity)
                return out.to(dtype)
            sx = torch.clamp(torch.amax(torch.abs(x32)), min=_EPS)
            out = grmac_matmul(x32 / sx, unpack_weight(pw), fmt_x=cfg.fmt_x,
                               fmt_w=cfg.fmt_w, n_r=cfg.n_r,
                               enob=cfg.resolved_enob(),
                               granularity=cfg.granularity, backend=backend)
            return (out * (sx * pw.sw)).to(dtype)
    w32 = w.to(torch.float32)
    sx = torch.clamp(torch.amax(torch.abs(x32)), min=_EPS)
    sw = torch.clamp(torch.amax(torch.abs(w32)), min=_EPS)
    xn = x32 / sx
    wn = w32 / sw
    if cfg.mode == "fakequant":
        out = quantize_any(xn, cfg.fmt_x) @ quantize(wn, cfg.fmt_w)
    elif cfg.mode == "grmac":
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


def _check_fp_input(cfg: CIMConfig) -> None:
    if isinstance(cfg.fmt_x, IntFormat):
        raise NotImplementedError(
            "grmac execution with an IntFormat input is not "
            "implemented (the gr_int signal chain has no kernel): "
            "deploy INT designs with mode='fakequant', or pick an FP "
            "format")


def _check_packed(w: PackedWeight, x: torch.Tensor, eff) -> None:
    """A packed weight serves the grmac design it was packed for."""
    if eff is None or eff.mode != "grmac":
        raise ValueError("a PackedWeight serves grmac sites only, this site "
                         f"runs {'off' if eff is None else eff.mode!r}")
    if (w.fmt_w, w.n_r) != (eff.fmt_w, eff.n_r):
        raise ValueError(f"weight packed as {w.fmt_w.name} at n_r={w.n_r}, "
                         f"the site runs {eff.fmt_w.name} at n_r={eff.n_r}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("a PackedWeight is for serving: it has no "
                           "gradient; train with the raw weight tensor")


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
    w: Union[torch.Tensor, PackedWeight],
    cfg: Optional[CIMConfig] = None,
    *,
    site: Optional[str] = None,
    backend: Optional[str] = None,
    logical_n: Optional[int] = None,
) -> torch.Tensor:
    """(..., K) @ (K, N) with CIM numerics per ``cfg.for_site(site)``
    (None/off = exact digital matmul).

    ``site=None`` treats ``cfg`` as already resolved. Backend precedence:
    ``backend=`` argument > ``cfg.backend``. A ``PackedWeight`` serves
    only a site that resolves to the grmac design it was packed for.
    """
    eff = cfg.for_site(site) if cfg is not None else None
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    m = math.prod(lead)
    costs.record_matmul(site, m, k, n if logical_n is None else logical_n,
                        eff)
    if x.device.type == "meta":
        return x.new_empty(*lead, n)
    if isinstance(w, PackedWeight):
        _check_packed(w, x, eff)
    elif eff is None or not eff.enabled:
        return x @ w
    backend = resolve_backend(backend or eff.backend)
    x2 = x.reshape(m, k)
    if isinstance(w, PackedWeight):
        out = _cim_matmul_2d(x2, w, eff, backend)
    else:
        out = _CimMatmulSTE.apply(x2, w, eff, backend)
    return out.reshape(*lead, n)
