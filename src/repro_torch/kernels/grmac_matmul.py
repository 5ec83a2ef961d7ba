"""Build, bind and launch the hand-written Hopper GR-MAC kernel.

The kernel is ``csrc/grmac_matmul.cu`` (it replaces
``repro.kernels.grmac_matmul.grmac_matmul_pallas``; the source's header
says what bounds it and how it is laid out). It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface the first
time it is needed, into ``build/repro_torch/`` at the root of the
checkout, and loaded with ``ctypes``. The library's name carries a hash of
the source and flags, so an edited source is rebuilt.

``grmac_matmul_cuda`` takes CUDA tensors only and launches the kernel or
raises: there is no fallback to the plain version (``kernels/ref.py``),
which ``kernels.dispatch`` takes for CPU tensors. ``grmac_matmul_cuda.
launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.formats import FPFormat
from repro_torch.core.mac import adc_delta

__all__ = ["N_R_SUPPORTED", "NVCC_FLAGS", "BuildInfo", "build",
           "grmac_matmul_cuda"]

N_R_SUPPORTED = (16, 32, 64, 128)   # the DSE ladder; template instances
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_GRANULARITY = {"conv": 0, "row": 1, "unit": 2}
_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "grmac_matmul.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float        # compile time of this process's build, 0 if reused
    ptxas: str            # nvcc's -Xptxas -v report (registers, smem, spills)


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the GR-MAC kernel is built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def build() -> BuildInfo:
    """Compile the kernel library if this source has not been built yet,
    load it, and return where it is, how long the build took and ptxas's
    report. Raises if nvcc fails."""
    global _lib, _info
    if _info is not None:
        return _info
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"grmac_matmul-{tag}.so"
    log_path = lib_path.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)     # atomic: a reader never sees half a file
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.grmac_matmul_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    _info = BuildInfo(str(lib_path), seconds,
                      log_path.read_text() if log_path.exists() else "")
    return _info


def _check_format(fmt, what: str) -> None:
    if not isinstance(fmt, FPFormat):
        raise TypeError(f"{what} must be an FPFormat, got {fmt!r}")
    # keeps every 2^e the kernel assembles inside the normal f32 range
    if not (1 <= fmt.n_exp <= 6 and 0 <= fmt.n_man <= 23):
        raise ValueError(f"{what} {fmt.name} is outside the kernel's range "
                         "(n_exp in [1, 6], n_man in [0, 23])")


def grmac_matmul_cuda(
    x: torch.Tensor,
    wq: torch.Tensor,
    *,
    fmt_x: FPFormat,
    fmt_w: FPFormat,
    n_r: int = 32,
    enob: float = 8.0,
    granularity: str = "row",
) -> torch.Tensor:
    """(M, K) @ (K, N) GR-MAC matmul on the card; float32 out.

    ``x`` and ``wq`` are contiguous float32 CUDA tensors on one device, with
    ``K`` a multiple of ``n_r`` (``kernels.dispatch`` pads); ``x`` is
    pre-scaled to [-1, 1] and ``wq`` is on the ``fmt_w`` grid.
    """
    if x.device.type != "cuda" or wq.device != x.device:
        raise ValueError(f"grmac_matmul_cuda needs both operands on one CUDA "
                         f"device, got {x.device} and {wq.device}")
    if x.dtype != torch.float32 or wq.dtype != torch.float32:
        raise TypeError(f"float32 operands expected, got {x.dtype}, {wq.dtype}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(wq.shape)} "
                         "are not (M, K) @ (K, N)")
    if not (x.is_contiguous() and wq.is_contiguous()):
        raise ValueError("grmac_matmul_cuda needs contiguous operands")
    if n_r not in N_R_SUPPORTED:
        raise ValueError(f"n_r={n_r} not in {N_R_SUPPORTED}")
    if granularity not in _GRANULARITY:
        raise ValueError(f"unknown granularity {granularity!r}")
    _check_format(fmt_x, "fmt_x")
    _check_format(fmt_w, "fmt_w")
    m, k = x.shape
    n = wq.shape[1]
    if k % n_r:
        raise ValueError(f"K={k} is not a multiple of n_r={n_r}")
    if max(m * k, k * n, m * n) >= 2**31 or min(m, k, n) == 0:
        raise ValueError(f"shape ({m}, {k}) @ ({k}, {n}) out of range")
    build()
    delta = adc_delta(enob)
    # a power-of-two step lets the kernel multiply by 1/delta exactly
    inv_delta = 1.0 / delta if math.frexp(delta)[0] == 0.5 else 0.0
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.grmac_matmul_f32(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(wq.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), m, n, k, n_r,
            _GRANULARITY[granularity], fmt_x.n_exp, fmt_x.n_man, fmt_w.n_exp,
            delta, inv_delta, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"grmac_matmul kernel launch failed: cudaError {err}")
    grmac_matmul_cuda.launches += 1
    return out


grmac_matmul_cuda.launches = 0
