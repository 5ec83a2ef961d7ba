"""Numerics sanitizer for the GR-MAC kernel and its plain version; the
port's counterpart of ``repro.analysis.sanitize``.

``REPRO_SANITIZE=1`` (read on every call) makes every GR-MAC call check
the pre-ADC compute-line voltage of every block:

``nonfinite``
    any NaN/Inf in the voltage ``v`` entering the ADC: the symptom of a
    zero or denormal denominator or of an upstream blowup;
``adc_overflow``
    ``|v| > 1`` beyond float slack (``OVERFLOW_TOL``): local normalization
    keeps the compute line inside the ADC's full scale, so an overflow
    means the gain ranging did not cover the operands it claimed to;
``gain_range``
    the per-block exponent span ``max(E) - min(E)`` (row granularity: of
    x per (row, block); unit: of ``E(x) + E(w)`` per (row, block, col))
    above ``core.dse.GAIN_RANGE_LIMIT_BITS``, the C-2C ladder depth the
    DSE treats as a feasibility wall. This checks the paper's central
    claim on the actual operands.

Where the checks run: the plain version (``kernels/ref.py``) computes them
with torch operations beside its own; the CUDA kernel has a sanitizing
instantiation (a compile-time flag) that counts violations inside the
kernel and accumulates four numbers a call into a small device buffer
(``kernels/grmac_matmul.py``). Both report the reference's records, in
call order: ``{"kind", "tag", "count", "worst"}``, one stderr line each,
``tag`` the site threaded down from ``ops.cim_matmul``. With the flag
unset nothing is checked, no buffer is allocated, and the kernel launches
its plain instantiation.

How the port differs from ``jax.debug.callback``: reading a call's counts
at once would cost a device→host sync per projection (85 a forward of
paper-cim-120m) and break the engine's one-fetch-a-step rule. So a call
leaves a pending record that holds device tensors, and the records are
materialized, in call order and with one transfer, when ``VIOLATIONS`` is
read (iterated, indexed, compared, its length taken) or ``flush()`` is
called.

Usage::

    REPRO_SANITIZE=1 python ...            # or monkeypatch.setenv in tests
    from repro_torch.analysis import sanitize
    sanitize.clear()
    ... run model / kernels ...
    assert not sanitize.VIOLATIONS, sanitize.VIOLATIONS
"""
from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.dse import GAIN_RANGE_LIMIT_BITS

__all__ = [
    "ENV_VAR",
    "OVERFLOW_TOL",
    "VIOLATIONS",
    "enabled",
    "clear",
    "flush",
    "check_values",
    "check_gain_span",
    "defer_kernel",
]

ENV_VAR = "REPRO_SANITIZE"

# |v| may legitimately graze 1.0 (full-scale inputs) and float renorm can
# overshoot by a few ulp; anything past this slack is a real range escape.
# The kernel compares against the same float32 value.
OVERFLOW_TOL = 1.0 + 1e-5

_KINDS = ("nonfinite", "adc_overflow", "gain_range")

# Pending records, in call order: (tag, kinds, stats, from_kernel). stats
# is a device tensor: float64 (nonfinite, overflow, worst |v|, gain count,
# worst span) from the plain version, int64 with worst |v| as float32
# bits from the kernel's buffer.
_PENDING: List[Tuple[str, tuple, torch.Tensor, bool]] = []


def enabled() -> bool:
    """Whether ``REPRO_SANITIZE`` currently requests instrumentation."""
    return os.environ.get(ENV_VAR, "0") not in ("", "0")


class _Violations(list):
    """The records list; reading it materializes the pending records."""

    def __len__(self):
        flush()
        return super().__len__()

    def __iter__(self):
        flush()
        return super().__iter__()

    def __getitem__(self, i):
        flush()
        return super().__getitem__(i)

    def __eq__(self, other):
        flush()
        return list.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        flush()
        return super().__repr__()

    __hash__ = None


# Violation records: {"kind", "tag", "count", "worst"} dicts, in execution
# order. Host-side state: clear() between runs.
VIOLATIONS: List[dict] = _Violations()


def _record(kind: str, tag: str, count: int, worst: float) -> None:
    if not count:
        return
    rec = {"kind": kind, "tag": str(tag) or "<untagged>",
           "count": int(count), "worst": float(worst)}
    VIOLATIONS.append(rec)
    print(f"[repro_torch.sanitize] {rec['kind']} at {rec['tag']}: "
          f"count={rec['count']} worst={rec['worst']:g}", file=sys.stderr)


def flush() -> None:
    """Materialize the pending records, in call order, with one transfer
    of the pending counts per device."""
    if not _PENDING:
        return
    pending = list(_PENDING)
    _PENDING.clear()
    host = {}
    by_device = {}
    for i, (_, _, stats, _) in enumerate(pending):
        by_device.setdefault(stats.device, []).append(i)
    for idx in by_device.values():
        # one stack per dtype: plain records are float64, kernel ones int64
        for dtype in (torch.float64, torch.int64):
            sel = [i for i in idx if pending[i][2].dtype == dtype]
            if sel:
                rows = torch.stack([pending[i][2] for i in sel]).cpu()
                host.update(zip(sel, rows.numpy()))
    for i, (tag, kinds, _, from_kernel) in enumerate(pending):
        row = host[i]
        if from_kernel:
            worst_v = float(np.array([row[2]], np.int64).astype(
                np.uint32).view(np.float32)[0])
        else:
            worst_v = float(row[2])
        stats = {"nonfinite": (row[0], float("inf")),
                 "adc_overflow": (row[1], worst_v),
                 "gain_range": (row[3], float(row[4]))}
        for kind in kinds:
            _record(kind, tag, int(stats[kind][0]), stats[kind][1])


def clear() -> None:
    """Drop the records and the pending ones."""
    _PENDING.clear()
    list.clear(VIOLATIONS)


def _defer(tag: str, kinds: tuple, stats: torch.Tensor,
           from_kernel: bool = False) -> None:
    _PENDING.append((tag, kinds, stats, from_kernel))


def _value_stats(v: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(v)
    nonfin = v.numel() - finite.sum()
    mag = torch.abs(torch.where(finite, v, 0.0))
    worst = mag.max() if v.numel() else torch.zeros((), device=v.device)
    over = (mag > OVERFLOW_TOL).sum()
    return torch.stack([t.to(torch.float64) for t in (nonfin, over, worst)])


def check_values(tag: str, v: torch.Tensor) -> None:
    """Check compute-line ``v`` for nonfinite values and pre-ADC overflow
    (the plain version's checks; deferred, see the module docstring)."""
    zero = torch.zeros(2, dtype=torch.float64, device=v.device)
    _defer(tag, _KINDS[:2], torch.cat([_value_stats(v), zero]))


def check_gain_span(tag: str, span_bits: torch.Tensor,
                    limit: int = GAIN_RANGE_LIMIT_BITS) -> None:
    """Check per-block exponent spans against the gain-range limit."""
    worst = (span_bits.max() if span_bits.numel()
             else torch.zeros((), device=span_bits.device))
    count = (span_bits > limit).sum()
    stats = torch.zeros(5, dtype=torch.float64, device=span_bits.device)
    stats[3] = count.to(torch.float64)
    stats[4] = worst.to(torch.float64)
    _defer(tag, _KINDS[2:], stats)


def defer_kernel(tag: str, buf: torch.Tensor, spans: bool) -> None:
    """A kernel call's buffer: int64 (nonfinite, overflow, worst |v| as
    float32 bits, gain count, worst span), filled on the device."""
    _defer(tag, _KINDS if spans else _KINDS[:2], buf, from_kernel=True)
