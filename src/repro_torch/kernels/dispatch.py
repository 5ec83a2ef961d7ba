"""One entry point for the GR-MAC matmul: ``grmac_matmul(x, wq, ...)``.

It owns the shape-padding contract, so every caller sees plain
``(M, K) @ (K, N)``: K is zero-padded to a multiple of ``n_r`` (an analog
column always has ``n_r`` physical rows; a padded zero quantizes to 0 and
still adds its minimum gain 2^1 to the row denominator, exactly like an
unused hardware row). M and N need no padding.

=========  ==============================================================
backend    implementation
=========  ==============================================================
``auto``   the CUDA kernel (``grmac_matmul.grmac_matmul_cuda``) for a
           CUDA tensor, the plain version (``ref.grmac_matmul_ref``) for
           a CPU tensor
``ref``    the plain version on the CPU or the card (the oracle the
           kernel is held against on the card)
=========  ==============================================================

A tensor on any other device (``meta`` included) raises: nothing falls
back to the plain version quietly.

On the card ``wq`` is encoded into codes (``packed.pack_quantized``, with
unit scales, checked to decode back to ``wq``) for the kernel, which reads
weights only as codes; ``kernels.ops`` serves prepared weights directly.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis import sanitize
from repro_torch.core.formats import FPFormat

from .grmac_matmul import grmac_matmul_cuda
from .packed import pack_quantized, unpack_weight
from .ref import grmac_matmul_ref

__all__ = ["BACKENDS", "resolve_backend", "pad_to_multiple", "grmac_matmul"]

BACKENDS = ("auto", "ref")


def resolve_backend(backend: Optional[str] = None) -> str:
    """None -> "auto"; an unknown name raises."""
    b = backend or "auto"
    if b not in BACKENDS:
        raise ValueError(
            f"unknown GR-MAC backend {b!r}; expected one of {BACKENDS}")
    return b


def pad_to_multiple(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor along ``axis`` up to a multiple of ``mult``."""
    pad = -x.shape[axis] % mult
    if pad == 0:
        return x
    return F.pad(x, (0, pad) if axis == 1 else (0, 0, 0, pad))


def grmac_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    *,
    fmt_x: FPFormat,
    fmt_w: FPFormat,
    n_r: int = 32,
    enob: float = 8.0,
    granularity: str = "row",
    backend: Optional[str] = None,
    design: Optional[str] = None,
    tag: str = "",
) -> torch.Tensor:
    """(M, K) @ (K, N) GR-MAC matmul; float32 out.

    ``x`` pre-scaled to [-1, 1]; ``wq`` already on the weight format grid.
    ``design`` forces one of the kernel's designs (None: its own choice).
    ``tag`` names the call in the sanitizer's records: with
    ``REPRO_SANITIZE`` set (read on every call) the plain version checks,
    or the kernel launches its sanitizing instantiation.
    """
    b = resolve_backend(backend)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"GR-MAC on a {x.device.type} tensor: the kernel runs on CUDA "
            "tensors and the plain version on CPU tensors")
    if b == "ref" or x.device.type == "cpu":
        return grmac_matmul_ref(
            pad_to_multiple(x, 1, n_r), pad_to_multiple(wq, 0, n_r),
            fmt_x=fmt_x, fmt_w=fmt_w, n_r=n_r, enob=enob,
            granularity=granularity, sanitize=sanitize.enabled(), tag=tag)
    one = torch.ones((), dtype=torch.float32, device=wq.device)
    packed = pack_quantized(wq.to(torch.float32), one, fmt_w, n_r)
    if not torch.equal(unpack_weight(packed)[:wq.shape[0]], wq):
        raise ValueError(f"wq is not on the {fmt_w.name} grid")
    return grmac_matmul_cuda(x.to(torch.float32).contiguous(), packed, one,
                             fmt_x=fmt_x, enob=enob, granularity=granularity,
                             design=design, tag=tag)
