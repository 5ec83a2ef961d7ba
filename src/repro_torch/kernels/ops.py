"""The CIM matmul the model layers call.

``cim_matmul(x, w, cfg, site=...)`` is a matmul over the last dim of
``x``: (..., K) @ (K, N) -> (..., N).

0. per-site policy: ``cfg.for_site(site)`` resolves which design (or
   "off") runs at this call site;
1. dynamic pre-scale: activations are normalized into [-1, 1] by their
   per-tensor absmax (one absmax over the whole flattened activation, so
   every row of a batch shapes every other row's numbers); weights likewise.
   Under the SPMD program of ``parallel.sharding`` x arrives as this rank's
   rows (the same on every "model" rank) and the weight as this rank's
   N-chunk (or whole, where N does not divide "model"), with K whole; the
   absmax of x is the max over the batch axes and the weight's over
   "model" (``sharding.all_reduce_max``), so each output element sees the
   same pre-scales, weight column and K order as without a mesh;
2. mode dispatch:
     off        exact matmul (digital baseline)
     fakequant  format-grid quantization of x and w, exact accumulation
     grmac      the GR-MAC block simulation through ``kernels.dispatch``
3. straight-through gradients: the backward applies the exact-matmul
   gradient to the *raw* saved operands, so the op is trainable and its
   backward is digital.

``x`` and ``w`` may be DTensors: the weight is gathered to its full K x
N, x redistributed so that K is whole on every rank and its rows lie
over the batch axes only, and the op runs on the local tensors with the
absmax of x taken over every rank; the output is a DTensor placed as x's
rows (``_on_dtensors``). The kernel is never handed a DTensor.

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
runs; under autograd that tensor carries the STE's backward, so a train
trace still differentiates through the projection. Each such call is
told to the ``META_WATCHERS`` with its operands and N, since no op of it
reaches a dispatch mode that counts flops and bytes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Union

import torch

from repro_torch.core import costs
from repro_torch.core.cim_config import CIMConfig
from repro_torch.core.formats import IntFormat, quantize, quantize_any
from repro_torch.core.scopes import named_scope
from repro_torch.parallel import sharding

from .dispatch import grmac_matmul, pad_to_multiple, resolve_backend
from .grmac_matmul import grmac_matmul_cuda
from .packed import EPS as _EPS
from .packed import PackedWeight, pack_weight, unpack_weight
from .ref import grmac_matmul_ref

__all__ = ["cim_matmul", "site_marker", "plain_on_meta", "META_WATCHERS"]

_PLAIN_ON_META = [False]
# callables told (x, w, N) of every call the ``meta`` short-circuit
# answers without a matmul (its output: x's dtype, N columns), so a trace
# can price the work it hides (``launch.roofline.TraceCounter``)
META_WATCHERS: list = []


def site_marker(site: Optional[str], m: int, k: int, n: int) -> str:
    """The audit marker naming one ledger contract, in the reference's
    grammar: parsed back by ``analysis.op_audit`` (site names contain
    underscores, so the ``_m<digits>`` suffix anchors the parse)."""
    return f"cim_{site or 'unsited'}_m{m}_k{k}_n{n}"


@contextlib.contextmanager
def plain_on_meta():
    """Within the block, ``cim_matmul`` on ``meta`` runs the plain
    version's operations (shapes only) instead of returning an empty
    tensor: the audit's regime. The ledger traces stay outside it."""
    _PLAIN_ON_META.append(True)
    try:
        yield
    finally:
        _PLAIN_ON_META.pop()


def _over_batch(amax: torch.Tensor) -> torch.Tensor:
    """x's absmax over every rank: its rows lie over the batch axes, and
    every "model" rank holds the same rows whole (``parallel.sharding``)."""
    return sharding.all_reduce_max(amax, axes=sharding.batch_axes() or ())


def _over_model(amax: torch.Tensor) -> torch.Tensor:
    """A weight's absmax over every rank: a rank may hold its N-chunk over
    "model"; the batch axes hold it gathered."""
    return sharding.all_reduce_max(amax, axes=("model",))


def _plain_grmac(x: torch.Tensor, wq: torch.Tensor, backend: str, **kw):
    """The plain GR-MAC: through ``dispatch`` on real tensors; on ``meta``
    (the audit's regime only) the plain version directly, which
    ``dispatch`` refuses to take there."""
    if x.device.type != "meta":
        return grmac_matmul(x, wq, backend=backend, **kw)
    n_r = kw["n_r"]
    return grmac_matmul_ref(pad_to_multiple(x, 1, n_r),
                            pad_to_multiple(wq, 0, n_r), **kw)


def _cim_matmul_2d(x: torch.Tensor, w: Union[torch.Tensor, PackedWeight],
                   cfg: CIMConfig, backend: str,
                   tag: str = "") -> torch.Tensor:
    """(M, K) @ (K, N) with CIM numerics (forward only); ``tag`` names
    the site for the sanitizer and never changes numerics."""
    dtype = x.dtype
    x32 = x.to(torch.float32)
    if cfg.mode == "grmac":
        _check_fp_input(cfg)
        on_card = x32.device.type == "cuda" and backend == "auto"
        if on_card or isinstance(w, PackedWeight):
            pw = w
            if not isinstance(w, PackedWeight):
                with named_scope("cim.pack"):
                    pw = pack_weight(w, cfg.fmt_w, cfg.n_r,
                                     reduce=_over_model)
            if on_card:
                # max |x| in one reduction (the kernel clamps it to sx)
                with named_scope("cim.prescale"):
                    amax = _over_batch(
                        torch.linalg.vector_norm(x32, float("inf")))
                out = grmac_matmul_cuda(
                    x32.contiguous(), pw, amax, fmt_x=cfg.fmt_x,
                    enob=cfg.resolved_enob(), granularity=cfg.granularity,
                    tag=tag)
                return out.to(dtype)
            with named_scope("cim.prescale"):
                sx = torch.clamp(
                    _over_batch(torch.amax(torch.abs(x32))), min=_EPS)
            out = grmac_matmul(x32 / sx, unpack_weight(pw), fmt_x=cfg.fmt_x,
                               fmt_w=cfg.fmt_w, n_r=cfg.n_r,
                               enob=cfg.resolved_enob(),
                               granularity=cfg.granularity, backend=backend,
                               tag=tag)
            return (out * (sx * pw.sw)).to(dtype)
    w32 = w.to(torch.float32)
    with named_scope("cim.prescale"):
        sx = torch.clamp(_over_batch(torch.amax(torch.abs(x32))), min=_EPS)
    sw = torch.clamp(_over_model(torch.amax(torch.abs(w32))), min=_EPS)
    xn = x32 / sx
    wn = w32 / sw
    if cfg.mode == "fakequant":
        xq, wq = quantize_any(xn, cfg.fmt_x), quantize(wn, cfg.fmt_w)
        with named_scope("cim_values"):
            out = xq @ wq
    elif cfg.mode == "grmac":
        out = _plain_grmac(
            xn,
            quantize(wn, cfg.fmt_w),
            backend,
            fmt_x=cfg.fmt_x,
            fmt_w=cfg.fmt_w,
            n_r=cfg.n_r,
            enob=cfg.resolved_enob(),
            granularity=cfg.granularity,
            tag=tag,
        )
    else:  # off
        with named_scope("cim_values"):
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
    def forward(ctx, x, w, cfg, backend, tag):
        ctx.save_for_backward(x, w)
        return _cim_matmul_2d(x, w, cfg, backend, tag)

    @staticmethod
    def backward(ctx, g):
        return (*_ste_backward(ctx, g), None, None, None)


def _ste_backward(ctx, g):
    x, w = ctx.saved_tensors
    # digital by design: the backward never reaches the analog array
    with named_scope("dig_ste_bwd"):
        gx = (g @ w.T.to(g.dtype)).to(x.dtype)
        gw = (x.T.to(g.dtype) @ g).to(w.dtype)
    return gx, gw


class _MetaSTE(torch.autograd.Function):
    """The ``meta`` short-circuit of a differentiated call: an empty
    forward (no CIM numerics on shapes) and the STE's backward, whose
    digital matmuls a train trace (``launch.roofline``) counts."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.new_empty(x.shape[0], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return _ste_backward(ctx, g)


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
    if sharding.is_dtensor(x) or sharding.is_dtensor(w):
        return _on_dtensors(x, w, cfg, site=site, backend=backend,
                            logical_n=logical_n)
    eff = cfg.for_site(site) if cfg is not None else None
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[-1]
    m = math.prod(lead)
    ledger_n = n if logical_n is None else logical_n
    costs.record_matmul(site, m, k, ledger_n, eff)
    if x.device.type == "meta" and not _PLAIN_ON_META[-1]:
        # told first: a checkpoint's recomputation may stop inside the
        # apply below, once the backward has what it needs, where the
        # device has launched the projection already
        for watch in META_WATCHERS:
            watch(x, w, n)
        if (torch.is_grad_enabled() and not isinstance(w, PackedWeight)
                and (x.requires_grad or w.requires_grad)):
            # a train trace: the STE's digital backward still runs
            return _MetaSTE.apply(x.reshape(m, k), w).reshape(*lead, n)
        return x.new_empty(*lead, n)
    with named_scope(site_marker(site, m, k, ledger_n)):
        if isinstance(w, PackedWeight):
            _check_packed(w, x, eff)
        elif eff is None or not eff.enabled:
            with named_scope("cim_values"):
                return x @ w
        backend = resolve_backend(backend or eff.backend)
        x2 = x.reshape(m, k)
        if isinstance(w, PackedWeight):
            out = _cim_matmul_2d(x2, w, eff, backend, site or "")
        else:
            out = _CimMatmulSTE.apply(x2, w, eff, backend, site or "")
    return out.reshape(*lead, n)


def _on_dtensors(x, w, cfg, **kw):
    """``cim_matmul`` on DTensor operands (module docstring): each rank
    computes its rows against the whole weight, the pre-scale's absmax the
    max over every rank. The weight's gradient is summed over the mesh
    dimensions that split x's rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return cim_matmul(x, sharding.gather_full(w), cfg, **kw)
    mesh = x.device_mesh
    last = x.ndim - 1
    # K whole, and the same rows on every "model" rank (the SPMD program's
    # layout, whose x absmax reduces over the batch axes)
    pl = [Replicate() if a == "model" or p.is_partial() or (
        isinstance(p, Shard) and p.dim % x.ndim == last) else p
        for a, p in zip(mesh.mesh_dim_names, x.placements)]
    x_l = x.redistribute(mesh, pl).to_local()
    if isinstance(w, DTensor):
        w = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=[Partial() if isinstance(p, Shard)
                             else Replicate() for p in pl])
    with sharding.use_mesh(mesh), sharding.spmd():
        out = cim_matmul(x_l, w, cfg, **kw)
    return DTensor.from_local(out, mesh, pl, run_check=False)
