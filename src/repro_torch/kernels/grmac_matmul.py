"""Build, bind and launch the hand-written Hopper GR-MAC kernel.

The kernel is ``csrc/grmac_matmul.cu`` and the two designs it routes to
(``grmac_decode.cu``, ``grmac_prefill.cu``; the headers say what bounds
each and how it is laid out). It replaces
``repro.kernels.grmac_matmul.grmac_matmul_pallas``. The first time it is
needed, each source is compiled by its own ``nvcc`` process for
``sm_90a``, all at once, and the objects are linked into one shared
library with a plain C interface, in ``build/repro_torch/`` at the root of
the checkout, loaded with ``ctypes``. The library's name carries a hash of
the sources and flags, so an edited source is rebuilt.

``grmac_matmul_cuda`` takes CUDA tensors only and launches the kernel or
raises: there is no fallback to the plain version (``kernels/ref.py``),
which ``kernels.ops`` and ``kernels.dispatch`` take for CPU tensors. It
reads x raw, the weight as a ``PackedWeight`` and the absmax of x, and
applies the pre- and post-scale itself. The kernel indexes in 32 bits, so
a call whose x or output reaches 2**31 elements is launched in row chunks
that stay below it (rows are independent, and every chunk reads the one
absmax: the result is the unchunked one). ``grmac_matmul_cuda.launches``
counts its launches, ``launches_by_design`` per design.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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

from .packed import N_R_SUPPORTED, PackedWeight

__all__ = ["N_R_SUPPORTED", "NVCC_FLAGS", "DESIGNS", "DECODE_MAX_M",
           "DECODE_MAX_K", "BuildInfo", "build", "choose_design",
           "grmac_matmul_cuda"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DESIGNS = ("decode", "prefill")
# The switch between the designs. Both split K to fill the card; the decode
# design (blocks of 8 rows) streams the weights again for every 8 rows,
# the tensor-core design (blocks of 64 x 64) does not. On the H100 the two
# cost about the same at M = 64 (paper-cim-120m's 85 launches: 2.56 and
# 2.45 ms, chip_smoke.py), so the decode design takes M up to 32. Its
# values dot is f32 FMA, so it takes every M for formats bf16 cannot hold.
DECODE_MAX_M = 32
DECODE_MAX_K = 16384     # K codes the decode design stages (shared memory)
_INDEX_LIMIT = 2**31     # the kernel's indices are 32-bit
_GRANULARITY = {"conv": 0, "row": 1, "unit": 2}
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str
    seconds: float        # wall time of this process's build, 0 if reused
    ptxas: str            # nvcc's -Xptxas -v report (registers, smem, spills)


_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the GR-MAC kernel is built with "
                           "the CUDA toolkit on the machine with the card")
    return nvcc


def _compile(lib_path: Path, log_path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    sources = sorted(_CSRC.glob("*.cu"))
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode, log)
              for s, p, log in zip(sources, procs, logs) if p.returncode]
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode:
            failed.append(("link", link.returncode,
                           link.stdout + link.stderr))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    log_path.write_text("".join(logs))
    os.replace(tmp, lib_path)     # atomic: a reader never sees half a file


def build() -> BuildInfo:
    """Compile the kernel library if these sources have not been built yet,
    load it, and return where it is, how long the build took and ptxas's
    report. Raises if nvcc fails."""
    global _lib, _info
    if _info is not None:
        return _info
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib_path = _BUILD_DIR / f"grmac_matmul-{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile(lib_path, log_path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.grmac_matmul_packed
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
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


@functools.lru_cache(maxsize=64)
def _adc_steps(enob: float):
    """The ADC step and, when it is a power of two (a product by it is then
    exact), its inverse, else 0; computed once per ENOB on the host."""
    delta = adc_delta(enob)
    return delta, 1.0 / delta if math.frexp(delta)[0] == 0.5 else 0.0


def _bf16_exact(fmt_x: FPFormat, fmt_w: FPFormat) -> bool:
    """Both formats' values are exact in bf16 (8 significant bits)."""
    return fmt_x.n_man <= 7 and fmt_w.n_man <= 7


def choose_design(m: int, w: PackedWeight, fmt_x: FPFormat) -> str:
    """The design a call of M rows takes: the tensor cores where both
    formats are exact in bf16 and M exceeds ``DECODE_MAX_M`` (or K exceeds
    what the decode design stages), else the decode design, whose values
    dot is f32 FMA. Formats bf16 cannot hold therefore take the decode
    design at every M, and are refused beyond ``DECODE_MAX_K``."""
    if not _bf16_exact(fmt_x, w.fmt_w):
        if w.k_store > DECODE_MAX_K:
            raise ValueError(
                f"{fmt_x.name} x {w.fmt_w.name} is not exact in bf16, so it "
                f"takes the decode design, which stages at most "
                f"{DECODE_MAX_K} K codes; got {w.k_store}")
        return "decode"
    if m <= DECODE_MAX_M and w.k_store <= DECODE_MAX_K:
        return "decode"
    return "prefill"


def grmac_matmul_cuda(
    x: torch.Tensor,
    w: PackedWeight,
    amax: torch.Tensor,
    *,
    fmt_x: FPFormat,
    enob: float = 8.0,
    granularity: str = "row",
    design: Optional[str] = None,
) -> torch.Tensor:
    """(M, K) @ (K, N) GR-MAC matmul on the card; float32 out.

    ``x`` is a contiguous float32 CUDA tensor, not yet pre-scaled; ``amax``
    is max |x| as a 0-d float32 tensor on the same device (the kernel takes
    sx = max(amax, 1e-12), reads it on the device: no sync). ``w`` holds
    the weight's codes and scale ``sw``. Returns ``grmac(x / sx, w_q) *
    (sx * sw)``. ``design`` (None: ``choose_design`` for the whole M)
    forces one of ``DESIGNS``; the tensor-core design refuses formats bf16
    cannot hold. Where M*K or M*N reaches 2**31 the rows go in chunks, one
    launch each; the weight itself must stay below 2**31 codes.
    """
    if not isinstance(w, PackedWeight):
        raise TypeError(f"a PackedWeight expected, got {type(w).__name__}")
    if x.device.type != "cuda" or w.device != x.device \
            or amax.device != x.device or w.sw.device != x.device:
        raise ValueError(f"grmac_matmul_cuda needs every operand on one CUDA "
                         f"device, got {x.device}, {w.device}, {amax.device}")
    if x.dtype != torch.float32 or amax.dtype != torch.float32:
        raise TypeError(f"float32 x and amax expected, got {x.dtype}, "
                        f"{amax.dtype}")
    if x.dim() != 2 or x.shape[1] != w.k or amax.numel() != 1:
        raise ValueError(f"shapes {tuple(x.shape)} @ {w.shape} are not "
                         "(M, K) @ (K, N), or amax is not a scalar")
    if not x.is_contiguous():
        raise ValueError("grmac_matmul_cuda needs a contiguous x")
    if granularity not in _GRANULARITY:
        raise ValueError(f"unknown granularity {granularity!r}")
    _check_format(fmt_x, "fmt_x")
    _check_format(w.fmt_w, "fmt_w")
    m, k = x.shape
    n = w.n
    if w.k_store * n >= _INDEX_LIMIT or min(m, k, n) == 0:
        raise ValueError(f"shape ({m}, {k}) @ ({k}, {n}) out of range")
    design = design or choose_design(m, w, fmt_x)
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; expected one of "
                         f"{DESIGNS}")
    if design == "prefill" and not _bf16_exact(fmt_x, w.fmt_w):
        raise ValueError(f"the tensor-core design needs formats exact in "
                         f"bf16, got {fmt_x.name} x {w.fmt_w.name}")
    if design == "decode" and w.k_store > DECODE_MAX_K:
        raise ValueError(f"the decode design stages at most {DECODE_MAX_K} "
                         f"K codes, got {w.k_store}")
    if _lib is None:
        build()
    delta, inv_delta = _adc_steps(float(enob))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fw = w.fmt_w
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # rows per launch: x's and the output's chunks below 2**31 elements, in
    # whole 64-row blocks of the tensor-core design
    lim = (_INDEX_LIMIT - 1) // max(k, n)
    rows = min(m, lim // 64 * 64 or lim)
    for r0 in range(0, m, rows):
        mc = min(rows, m - r0)
        args = (x.data_ptr() + 4 * r0 * k, w.codes.data_ptr(),
                w.lut.data_ptr(), amax.data_ptr(), w.sw.data_ptr(),
                out.data_ptr() + 4 * r0 * n, mc, n, k, w.k_store, w.n_r,
                w.code_bits, _GRANULARITY[granularity],
                DESIGNS.index(design), fmt_x.n_exp, fmt_x.n_man, fw.n_exp,
                fw.n_man, delta, inv_delta, stream)
        # the library launches on the current device: make it x's
        if x.device.index == torch.cuda.current_device():
            err = _lib.grmac_matmul_packed(*args)
        else:
            with torch.cuda.device(x.device):
                err = _lib.grmac_matmul_packed(*args)
        if err != 0:
            raise RuntimeError(f"grmac_matmul kernel launch failed "
                               f"({design}): cudaError {err}")
        grmac_matmul_cuda.launches += 1
        grmac_matmul_cuda.launches_by_design[design] += 1
    return out


grmac_matmul_cuda.launches = 0
grmac_matmul_cuda.launches_by_design = dict.fromkeys(DESIGNS, 0)
