"""Analysis passes of the port: machine-checked guarantees for the ledger
and the serving hot path; the counterpart of ``repro.analysis``.

``op_audit``  (run per config × {prefill, decode, train})
    Watches the aten operations of the functions the ledger traces
    (``core.costs.phase_trace_spec``, on ``meta``) and proves every
    contraction (``mm``/``bmm``/``addmm``/``baddbmm``/``convolution``...)
    is attributable: under a ``cim_<site>_m<M>_k<K>_n<N>`` marker whose
    ``cim_values`` count equals the CostLedger entry exactly, or under a
    declared-digital ``dig_*`` scope (``core.scopes``). Reports untagged
    contractions with their source file and line. The counterpart of
    ``jaxpr_audit`` (torch has no jaxpr).

``invariants``
    ``InstrumentedEngine`` counts at the engine's dispatch and fetch
    seams: each dispatch key's signature (GR-MAC calls, aten operations)
    must not drift, and each decode step fetches exactly once; on the
    card every device→host crossing is counted too and must equal the
    fetches.

``sanitize``
    The opt-in (``REPRO_SANITIZE=1``) numerics sanitizer: the plain
    version checks with torch operations, the CUDA kernel through its
    sanitizing instantiation; nonfinite, pre-ADC overflow and gain-range
    records per call site, materialized when read.

Report schema (``python -m repro_torch.analysis --out ...``): the
reference's, without ``bf16_regime`` (the port has no bf16-values switch)
and with ``signatures`` in each invariant config::

    {"schema": 1, "phases": [...], "failures": N,
     "configs": {"<name>": {"failures": N, "phases": {"<phase>": {
         dot_generals, convs, tagged_values, tagged_gains, tagged_other,
         declared_digital, transposes, untagged, untagged_details[],
         ledger_mismatches, ledger_mismatch_details[], dtype_f32,
         dtype_bf16, dtype_flags[], calls, macs,
         contracts: {"<site>_m<M>_k<K>_n<N>": {ledger, traced}}}}}},
     "invariants": {"violations": N, "configs": {"<name>": {
         traces{}, signatures{}, compiles, fetches, d2h, steps}}}, ...}

``dot_generals`` counts the contractions the audit saw (aten
operations, not jaxpr equations: the counts of the two packages differ
there; ``contracts``, ``calls`` and ``macs`` are equal).

Imports are lazy (``__getattr__``): the kernels import ``sanitize``, and
an eager package import would cycle through models → kernels → analysis.
"""
from __future__ import annotations

import importlib

__all__ = ["op_audit", "invariants", "sanitize", "cli"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")
