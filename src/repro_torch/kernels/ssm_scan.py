"""Launch the hand-written CUDA scan of the Mamba2 SSD recurrence.

The kernel is ``csrc/ssm_scan.cu`` (its header comment says what it
computes, what bounds it and how it is laid out). It is compiled into the
port's kernel library beside the GR-MAC sources, each source by its own
``nvcc`` process (``grmac_matmul.build``), and bound here with ``ctypes``.
One launch runs a layer's recurrence over a whole dispatch: every lane,
head and step of the chunk (S = 1 in decode). The state and the conv
window equal the per-step loop's bit for bit, and so does y at 8 lanes,
where the kernel sums over the state in cuBLAS's order for the loop's
einsum (the source's header says which).

``ssm_scan`` takes CUDA tensors only and launches the kernel or raises: it
never falls back. ``models.ssm`` takes it where ``applies`` (tensors on a
CUDA device) and runs its per-step loop, the plain version, on the CPU and
on ``meta``. ``ssm_scan.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .grmac_matmul import library

__all__ = ["WIDTHS", "applies", "ssm_scan"]

# (ssm_state N, ssm_headdim P, conv_width W) the kernel is instantiated
# for: mamba2-1.3b at full width and its reduced config
WIDTHS = ((128, 64, 4), (16, 32, 4))
_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LENGTH_DTYPES = {torch.int32: 4, torch.int64: 8}

_fn = None


def applies(device) -> bool:
    """Whether the scan runs the recurrence of tensors on ``device``: on a
    CUDA device only. Nothing else decides it (not the CIM backend: the
    recurrence is digital)."""
    return torch.device(device).type == "cuda"


def _bind():
    global _fn
    if _fn is None:
        fn = library().ssm_scan
        ll, p, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll,
                       p, p, p, p, p, p, i, p, p, p,
                       i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def ssm_scan(x: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
             dt: torch.Tensor, rate: torch.Tensor, d_skip: torch.Tensor,
             kernel: torch.Tensor, h: torch.Tensor, win: torch.Tensor,
             length: Optional[torch.Tensor] = None):
    """The SSD recurrence of one layer over S steps, on the card.

    x (B, S, NH * P) f32 or bf16, the conv's input; bmat / cmat (B, S, N)
    f32; dt (B, S, NH) f32; ``rate`` (NH,) or (1, NH) the decay rate
    exp(A_log); ``d_skip`` (NH,); ``kernel`` (W, NH * P) the conv taps; h
    (B, NH, N, P) and win (B, W - 1, NH * P) the f32 state. ``length`` (B,)
    int32 or int64: steps at t >= length[b] still give their y but leave
    the lane's state as it was; None commits every step. Returns (y (B, S,
    NH * P) f32 before the gate, new h, new win), new tensors: the inputs
    are not written.
    """
    if x.dim() != 3 or bmat.dim() != 3 or h.dim() != 4 or win.dim() != 3:
        raise ValueError(
            f"ssm_scan takes x (B, S, C), B / C (B, S, N), h (B, NH, N, P) "
            f"and win (B, W-1, C); got {tuple(x.shape)}, "
            f"{tuple(bmat.shape)}, {tuple(h.shape)}, {tuple(win.shape)}")
    b, s, _ = x.shape
    _, nh, n, hd = h.shape
    w = kernel.shape[0]
    if (n, hd, w) not in WIDTHS:
        raise ValueError(
            f"ssm_scan has no instance for ssm_state {n}, ssm_headdim {hd}, "
            f"conv_width {w}; it takes (N, P, W) in {WIDTHS}")
    rate = rate.reshape(-1)
    floats = (("x", x, (b, s, nh * hd)), ("bmat", bmat, (b, s, n)),
              ("cmat", cmat, (b, s, n)), ("dt", dt, (b, s, nh)),
              ("rate", rate, (nh,)), ("d_skip", d_skip, (nh,)),
              ("kernel", kernel, (w, nh * hd)), ("h", h, (b, nh, n, hd)),
              ("win", win, (b, w - 1, nh * hd)))
    named = floats + (() if length is None else (("length", length, (b,)),))
    for name, t, shape in named:
        if t.shape != shape:
            raise ValueError(f"ssm_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if s == 0 or b == 0:
        raise ValueError(f"ssm_scan: empty input {tuple(x.shape)}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"ssm_scan takes x in float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t, _ in floats[1:]:
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan takes {name} in float32, got "
                            f"{t.dtype}")
    if length is not None and length.dtype not in _LENGTH_DTYPES:
        raise TypeError(f"ssm_scan takes length in int32 or int64, got "
                        f"{length.dtype}")
    dev = x.get_device()
    if not x.is_cuda or any(t.get_device() != dev for _, t, _ in named):
        raise ValueError(f"ssm_scan needs every operand on one CUDA device, "
                         f"got {sorted({str(t.device) for _, t, _ in named})}")
    # the (B, S, ...) operands need unit stride along their last dimension
    # only: a slice of a projection's columns keeps its row strides
    x, bmat, cmat, dt = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (x, bmat, cmat, dt))
    rate, d_skip, kernel, h, win = (t.contiguous() for t in (
        rate, d_skip, kernel, h, win))
    if length is not None:
        length = length.contiguous()
    fn = _bind()
    y = torch.empty((b, s, nh * hd), dtype=torch.float32, device=x.device)
    h_new, win_new = torch.empty_like(h), torch.empty_like(win)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), _X_DTYPES[x.dtype], x.stride(0), x.stride(1),
            bmat.data_ptr(), bmat.stride(0), bmat.stride(1),
            cmat.data_ptr(), cmat.stride(0), cmat.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1),
            rate.data_ptr(), d_skip.data_ptr(), kernel.data_ptr(),
            h.data_ptr(), win.data_ptr(),
            None if length is None else length.data_ptr(),
            0 if length is None else _LENGTH_DTYPES[length.dtype],
            y.data_ptr(), h_new.data_ptr(), win_new.data_ptr(),
            b, s, nh, n, hd, w, stream)
    # the library launches on the current device: make it x's
    with torch.cuda.device(x.device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return y, h_new, win_new


ssm_scan.launches = 0
