"""Ledger audit over aten operations: prove the CostLedger covers every
contraction. The port's counterpart of ``repro.analysis.jaxpr_audit``
(torch has no jaxpr: the audit watches the aten operations a traced
function issues, through a ``TorchDispatchMode``).

The energy bound is only as good as the MAC accounting under it: a
contraction that escapes the ledger breaks it silently. This pass runs
the same functions the ledger traces (``core.costs.phase_trace_spec``:
a prefill dispatch, a decode step, a train step with its backward) on
``meta`` and classifies every contraction (``mm``, ``bmm``, ``addmm``,
``baddbmm``, ``convolution`` and the rest of ``MAC_OPS``; ``matmul`` and
``einsum`` decompose into them) by the scope stack (``core.scopes``) the
kernels and models stamp:

``cim_<site>_m<M>_k<K>_n<N>``
    one ``cim_matmul`` ledger contract (``kernels.ops.site_marker``); the
    nested ``cim_values`` scope marks the contraction that realizes it
    (``cim_gains`` unit granularity's denominator). The audit counts the
    ``cim_values`` contractions under the innermost marker and holds the
    count to the ledger entry's exactly.
``dig_*`` (``dig_attn``, ``dig_ssm_ssd``, ``dig_ste_bwd``)
    contractions that are digital by design (attention scores, the SSD
    forms, the STE backward), declared.
a backward node's contraction outside ``dig_ste_bwd``
    a ``transpose`` (autograd runs it: ``torch._C._current_autograd_node``
    is set), not counted against the ledger, which records forward
    contracts only: an untagged transpose implies an untagged forward,
    reported there.
anything else
    an **untagged** contraction: a ledger leak, reported with the source
    file and line of the first frame outside torch that issued it.

The regime (the counterpart of ``_audit_env``): ``cim_matmul`` on
``meta`` runs the plain version's operations (``ops.plain_on_meta``), the
sanitizer is off, the arch traces with ``remat=False`` (a recompute would
count every contract twice), and a GR-MAC kernel launch seen during the
trace is reported as opaque (the counterpart of ``pallas_call``).

Not ported: the reference's ``bf16_values_regime`` re-trace, which looks
for f32 promotions under ``REPRO_GRMAC_BF16_VALUES``; the port has no such
switch. ``dtype_flags`` stays in the report, empty.
"""
from __future__ import annotations

import contextlib
import os
import re
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import costs, scopes
from repro_torch.core.cim_config import SITES

__all__ = [
    "MARKER_RE",
    "MAC_OPS",
    "audit_phase",
    "audit_arch",
]

# Anchored on "_m<digits>_k<digits>_n<digits>": site names themselves
# contain underscores (attn_qkv, moe_expert) but never that suffix shape.
MARKER_RE = re.compile(r"cim_(?P<site>\w+?)_m(?P<m>\d+)_k(?P<k>\d+)_n(?P<n>\d+)")
DIG_RE = re.compile(r"dig_\w+")

_aten = torch.ops.aten
MAC_OPS = frozenset({
    _aten.mm.default, _aten.bmm.default, _aten.addmm.default,
    _aten.baddbmm.default, _aten.addbmm.default, _aten.mv.default,
    _aten.addmv.default, _aten.dot.default, _aten.vdot.default,
    _aten.convolution.default, _aten._convolution.default,
    _aten.convolution_backward.default,
})
_CONVS = frozenset({_aten.convolution.default, _aten._convolution.default,
                    _aten.convolution_backward.default})

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_SKIP_FILES = (_TORCH_DIR, str(Path(__file__).resolve()),
               str(Path(scopes.__file__).resolve()))


def _source() -> Tuple[Optional[str], Optional[int]]:
    """File and line of the innermost frame outside torch and the audit."""
    for frame in reversed(traceback.extract_stack()):
        name = str(Path(frame.filename).resolve())
        if not name.startswith(_SKIP_FILES):
            return frame.filename, int(frame.lineno)
    return None, None


class _Watch(TorchDispatchMode):
    """Records every contraction with its scope stack, dtype, whether a
    backward node issued it, and (when untagged) its source."""

    def __init__(self):
        super().__init__()
        self.seen: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in MAC_OPS:
            stack = list(scopes.current())
            rec = {"op": str(func.overloadpacket.__name__),
                   "conv": func in _CONVS,
                   "stack": stack,
                   "backward": torch._C._current_autograd_node() is not None,
                   "dtype": str(args[0].dtype).replace("torch.", "")
                   if args and isinstance(args[0], torch.Tensor) else None}
            if not any(MARKER_RE.fullmatch(s) or DIG_RE.fullmatch(s)
                       for s in stack):
                rec["file"], rec["line"] = _source()
            self.seen.append(rec)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _audit_env():
    """Pin the regime of a trace: the sanitizer off (its checks would leave
    records of meta tensors), ``cim_matmul`` running its plain operations
    on meta."""
    from repro_torch.kernels.ops import plain_on_meta

    saved = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "0"
    try:
        with plain_on_meta():
            yield
    finally:
        if saved is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = saved


def _ledger_contracts(ledger: costs.CostLedger) -> Dict[str, dict]:
    """Collapse ledger entries to marker-keyed contract records."""
    out: Dict[str, dict] = {}
    for entry, count in ledger.entries():
        key = f"{entry.site}_m{entry.m}_k{entry.k}_n{entry.n}"
        rec = out.setdefault(key, {"site": entry.site, "ledger": 0})
        rec["ledger"] += count
    return out


def _run(arch, phase: str):
    """The phase's traced function on ``meta``, run under the audit: the
    train phase through ``train_loss`` and its backward."""
    arch = arch.replace(remat=False)
    fn, args = costs.phase_trace_spec(arch, phase, grad=phase == "train")
    if phase == "train":
        fn(*args)
    else:
        with torch.no_grad():
            fn(*args)


def audit_phase(arch, phase: str) -> dict:
    """Audit one (arch, phase): trace, classify, cross-check.

    Returns a JSON-able dict; ``untagged == 0`` and
    ``ledger_mismatches == 0`` are the pass conditions.
    """
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    ledger = costs.CostLedger()
    watch = _Watch()
    launches = grmac_matmul_cuda.launches
    with _audit_env(), costs.recording(ledger), watch:
        _run(arch, phase)
    opaque = []
    if grmac_matmul_cuda.launches != launches:
        opaque.append({"primitive": "grmac_matmul_cuda",
                       "launches": grmac_matmul_cuda.launches - launches,
                       "file": None, "line": None})

    contracts = _ledger_contracts(ledger)
    for rec in contracts.values():
        rec["traced"] = 0

    n_dot = n_conv = 0
    tagged_values = tagged_gains = tagged_other = 0
    declared_digital = transposes = 0
    dtype_f32 = dtype_bf16 = 0
    untagged: List[dict] = []
    unknown_sites: List[dict] = []

    for rec in watch.seen:
        stack = rec["stack"]
        if rec["conv"]:
            n_conv += 1
        else:
            n_dot += 1
        if rec["backward"] and "dig_ste_bwd" not in stack:
            transposes += 1
            continue
        marker = None
        for name in stack:
            m = MARKER_RE.fullmatch(name)
            if m is not None:
                marker = m           # innermost marker wins
        if marker is not None:
            key = marker.group(0)[len("cim_"):]
            site = marker.group("site")
            c = contracts.get(key)
            if site not in SITES or c is None:
                unknown_sites.append(
                    {"marker": marker.group(0), "stack": "/".join(stack),
                     "reason": ("site not in SITES" if site not in SITES
                                else "no matching ledger contract")})
                continue
            if "cim_values" in stack:
                tagged_values += 1
                c["traced"] += 1
                if rec["dtype"] == "bfloat16":
                    dtype_bf16 += 1
                else:
                    dtype_f32 += 1
            elif "cim_gains" in stack:
                tagged_gains += 1
            else:
                # under a site marker but neither values nor gains: still
                # attributable, counted apart so the report surfaces them
                tagged_other += 1
            continue
        if any(DIG_RE.fullmatch(name) for name in stack):
            declared_digital += 1
            continue
        untagged.append({"primitive": rec["op"], "stack": "/".join(stack),
                         "file": rec.get("file"), "line": rec.get("line")})

    mismatches = [
        {"contract": key, "ledger": c["ledger"], "traced": c["traced"]}
        for key, c in sorted(contracts.items())
        if c["ledger"] != c["traced"]
    ]
    return {
        "phase": phase,
        "dot_generals": n_dot,
        "convs": n_conv,
        "tagged_values": tagged_values,
        "tagged_gains": tagged_gains,
        "tagged_other": tagged_other,
        "declared_digital": declared_digital,
        "transposes": transposes,
        "untagged": len(untagged),
        "untagged_details": untagged,
        "unknown_site_details": unknown_sites,
        "opaque_details": opaque,
        "ledger_mismatches": len(mismatches) + len(unknown_sites)
        + len(opaque),
        "ledger_mismatch_details": mismatches,
        "dtype_f32": dtype_f32,
        "dtype_bf16": dtype_bf16,
        "dtype_flags": [],
        "calls": sum(c["ledger"] for c in contracts.values()),
        "macs": ledger.macs(),
        "contracts": {
            key: {"ledger": c["ledger"], "traced": c["traced"]}
            for key, c in sorted(contracts.items())
        },
    }


def audit_arch(arch, phases=("prefill", "decode", "train")) -> dict:
    """Audit every phase of one arch (the reference's report without its
    ``bf16_regime`` re-trace)."""
    out = {"phases": {p: audit_phase(arch, p) for p in phases}}
    out["failures"] = sum(ph["untagged"] + ph["ledger_mismatches"]
                          for ph in out["phases"].values())
    return out
