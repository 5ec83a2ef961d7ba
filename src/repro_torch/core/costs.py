"""Trace-derived CIM cost accounting, the ``CostLedger``; the port's
counterpart of ``repro.core.costs``.

1. every projection carries a **site** label (``core.cim_config.SITES``)
   through ``kernels.ops.cim_matmul``;
2. a shape-only run of the port's *own* model functions
   (``models.decode_step``, ``models.prefill_step`` per bucket, and the
   train forward) on PyTorch's ``meta`` device, with parameters and caches
   from ``init_params`` / ``init_cache`` on ``meta``, runs under
   ``recording(ledger)``: every ``cim_matmul`` call (and the MoE expert
   stacks) records ``(site, M, K, N, mode, granularity, fmt_x, fmt_w,
   n_r)``. Nothing is allocated or computed: ``meta`` tensors carry shapes
   only (the counterpart of ``jax.eval_shape``), and the layers are a
   Python loop, so every layer records once;
3. pricing multiplies each entry's ops by the fJ/Op of that site's
   resolved design (``CIMConfig.for_site``), whose ADC resolution comes
   from the Monte-Carlo required-ENOB solve (``core.adc``); mixed per-site
   deployments (``site_overrides``) price per site.

Conventions (the reference's): counts are **logical** MACs. The MoE expert
stacks record ``tokens × top_k`` rows (the routed assignments), not the
``E × cap`` buffer; the LM head records ``vocab_size`` columns, not the
padded vocabulary. Sites that resolve to ``mode="off"`` are recorded (they
are real matmuls) and price as digital: zero analog energy. The STE
backward is digital by design, so a train ledger holds the forward's
analog ops only: the train trace is the forward without a cache. RG-LRU and
SSM blocks have no train form in the port yet, so their train trace raises
(it never returns a partial ledger).

The Monte-Carlo solves draw on ``device`` (None: the card); the traces
always run on ``meta``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from .adc import solve_required_enob
from .cim_config import CIMConfig
from .device import resolve_device
from .energy import CimDesign, TechParams, energy_per_op_fj
from .formats import FPFormat, IntFormat

__all__ = [
    "LedgerEntry",
    "CostLedger",
    "recording",
    "record_matmul",
    "phase_trace_spec",
    "trace_decode",
    "trace_prefill",
    "trace_train",
    "default_train_seq",
    "design_arch",
    "design_energy_fj",
    "price_ledger",
    "phase_report",
]

_GRAN_ARCH = {"row": "gr_row", "unit": "gr_unit", "conv": "conv"}
_META = torch.device("meta")


# ------------------------------------------------------------------ ledger
@dataclasses.dataclass(frozen=True)
class LedgerEntry:
    """One distinct matmul contract: a site executing (M, K) @ (K, N)
    under a resolved CIM design. The ledger maps entries to call counts."""

    site: str
    m: int
    k: int
    n: int
    mode: str                # off | fakequant | grmac
    granularity: str         # row | unit | conv
    fmt_x: FPFormat
    fmt_w: FPFormat
    n_r: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n

    @property
    def analog(self) -> bool:
        """Does this contract hit the analog array at deployment?
        ``fakequant`` counts: it is the QAT stand-in for ``grmac``."""
        return self.mode != "off"

    def design_key(self) -> tuple:
        return (self.granularity, self.fmt_x, self.fmt_w, self.n_r)


class CostLedger:
    """Counts of matmul contracts executed by one traced step."""

    def __init__(self):
        self._counts: Dict[LedgerEntry, int] = {}

    def add(self, entry: LedgerEntry, count: int = 1) -> None:
        self._counts[entry] = self._counts.get(entry, 0) + count

    def merge(self, other: "CostLedger", times: int = 1) -> "CostLedger":
        for e, c in other._counts.items():
            self.add(e, c * times)
        return self

    def entries(self) -> List[Tuple[LedgerEntry, int]]:
        return sorted(self._counts.items(),
                      key=lambda ec: (ec[0].site, ec[0].m, ec[0].k, ec[0].n))

    def macs(self, site: Optional[str] = None,
             analog_only: bool = False) -> int:
        return sum(e.macs * c for e, c in self._counts.items()
                   if (site is None or e.site == site)
                   and (not analog_only or e.analog))

    def sites(self) -> List[str]:
        return sorted({e.site for e in self._counts})

    def __len__(self) -> int:
        return len(self._counts)

    def as_dict(self) -> list:
        """JSON-able dump (formats by name), sorted for stable records."""
        return [
            {"site": e.site, "m": e.m, "k": e.k, "n": e.n, "count": c,
             "mode": e.mode, "granularity": e.granularity,
             "fmt_x": e.fmt_x.name, "fmt_w": e.fmt_w.name, "n_r": e.n_r}
            for e, c in self.entries()
        ]


# ----------------------------------------------------------- record hooks
_ACTIVE: List[CostLedger] = []


@contextlib.contextmanager
def recording(ledger: CostLedger):
    """Route every ``cim_matmul`` (and explicit ``record_matmul``) executed
    inside the block into ``ledger``, on any device, ``meta`` included."""
    _ACTIVE.append(ledger)
    try:
        yield ledger
    finally:
        _ACTIVE.pop()


def record_matmul(site: Optional[str], m: int, k: int, n: int,
                  cfg: Optional[CIMConfig]) -> None:
    """Record one (M, K) @ (K, N) contract at ``site`` under the *resolved*
    design ``cfg`` (None = plain digital matmul). No-op unless a
    ``recording`` context is active: the hot path pays one list check."""
    if not _ACTIVE:
        return
    if cfg is None:
        cfg = CIMConfig(mode="off")
    _ACTIVE[-1].add(LedgerEntry(
        site=site or "unsited", m=int(m), k=int(k), n=int(n),
        mode=cfg.mode, granularity=cfg.granularity,
        fmt_x=cfg.fmt_x, fmt_w=cfg.fmt_w, n_r=cfg.n_r))


# ------------------------------------------------------------------ traces
def _meta_params(arch):
    from repro_torch.models import init_params  # models import kernels.ops
    return init_params(arch, 0, device=_META)


def _meta_cache(arch, batch: int, ctx: int):
    from repro_torch.models import init_cache
    return init_cache(arch, batch, ctx, torch.float32, _META)


def _meta_inputs(arch, batch: int, seq: int) -> torch.Tensor:
    if arch.input_mode == "tokens":
        return torch.zeros((batch, seq), dtype=torch.int64, device=_META)
    return torch.zeros((batch, seq, arch.d_model), dtype=torch.float32,
                       device=_META)


def _meta_lanes(batch: int) -> torch.Tensor:
    return torch.zeros((batch,), dtype=torch.int64, device=_META)


def phase_trace_spec(arch, phase: str, *, batch: int = 1,
                     ctx: Optional[int] = None, bucket: int = 128,
                     seq_len: Optional[int] = None,
                     grad: bool = False) -> tuple:
    """The exact (callable, ``meta`` args) pair a phase trace runs: the
    single source of the traced functions, for the trace functions below
    and for any audit that must walk the same computation
    (``analysis.op_audit``). ``grad`` makes the train phase a train step:
    ``train_loss`` on parameters that require grad, and its backward (the
    ledger's trace takes the forward only)."""
    from repro_torch.models import decode_step, forward, prefill_step
    if phase == "decode":
        fn = lambda p, t, c, i: decode_step(p, t, arch, c, i)  # noqa: E731
        return fn, (_meta_params(arch), _meta_inputs(arch, batch, 1),
                    _meta_cache(arch, batch, ctx or 128), _meta_lanes(batch))
    if phase == "prefill":
        ctx = ctx or max(2 * bucket, 128)
        fn = lambda p, t, c, i, l: prefill_step(  # noqa: E731
            p, t, arch, c, i, l)
        return fn, (_meta_params(arch), _meta_inputs(arch, batch, bucket),
                    _meta_cache(arch, batch, ctx), _meta_lanes(batch),
                    _meta_lanes(batch))
    if phase == "train":
        if seq_len is None:
            seq_len = default_train_seq(arch)
        if grad:
            from repro_torch.models import train_loss
            from repro_torch.tree import tree_map

            def step(p, t, labels):
                train_loss(p, {"inputs": t, "labels": labels},
                           arch)[0].backward()

            params = tree_map(
                lambda a: a.requires_grad_() if a.is_floating_point() else a,
                _meta_params(arch))
            labels = torch.zeros((batch, seq_len), dtype=torch.int64,
                                 device=_META)
            return step, (params, _meta_inputs(arch, batch, seq_len), labels)
        fn = lambda p, t: forward(p, t, arch)  # noqa: E731
        return fn, (_meta_params(arch), _meta_inputs(arch, batch, seq_len))
    raise ValueError(f"unknown phase {phase!r}")


def _trace(fn, args) -> CostLedger:
    ledger = CostLedger()
    with recording(ledger), torch.no_grad():
        fn(*args)
    return ledger


def trace_decode(arch, batch: int = 1, ctx: int = 128) -> CostLedger:
    """Ledger of ONE decode step over ``batch`` lanes (→ ``batch`` tokens)."""
    return _trace(*phase_trace_spec(arch, "decode", batch=batch, ctx=ctx))


def trace_prefill(arch, bucket: int = 128, batch: int = 1,
                  ctx: Optional[int] = None) -> CostLedger:
    """Ledger of one bucketed prefill dispatch of ``bucket`` tokens per
    lane (→ ``batch * bucket`` tokens)."""
    return _trace(*phase_trace_spec(arch, "prefill", batch=batch,
                                    bucket=bucket, ctx=ctx))


def default_train_seq(arch) -> int:
    """The train trace's sequence length when the caller pins none: long
    enough to cover an SSM chunk. The divisor of every per-token train
    figure (it must be the length the trace ran)."""
    return max(arch.ssm_chunk, 128) if "ssm" in arch.block_pattern else 128


def trace_train(arch, batch: int = 1,
                seq_len: Optional[int] = None) -> CostLedger:
    """Ledger of one train step's *forward* (the STE backward is digital)
    over ``batch × seq_len`` tokens, for every block kind (RG-LRU by its
    associative scan, SSM by its chunked SSD form)."""
    return _trace(*phase_trace_spec(arch, "train", batch=batch,
                                    seq_len=seq_len))


# ----------------------------------------------------------------- pricing
def design_arch(granularity: str, fmt_x) -> str:
    """Energy-model arch of a (granularity, input format) pair: ``gr_row``
    / ``gr_unit`` for FP inputs, ``gr_int`` for INT inputs (no input
    exponent to range on: the gain ranging runs off the static weight
    exponents, §III-C3), ``conv`` for conv."""
    arch = _GRAN_ARCH[granularity]
    if arch != "conv" and isinstance(fmt_x, IntFormat):
        return "gr_int"
    return arch


def design_energy_fj(granularity: str, fmt_x, fmt_w, n_r: int, *,
                     n_cols: int = 1 << 11, seed: int = 0,
                     n_c: int = 32, device=None) -> dict:
    """fJ/Op of one (granularity, formats, n_r) design and of the
    conventional CIM processing the same tensors (the paper's §IV cost
    model), each at the ADC resolution its Monte-Carlo solve requires.
    Memoized per design, sampling configuration and device type."""
    return _design_energy(granularity, fmt_x, fmt_w, int(n_r), n_cols, seed,
                          n_c, resolve_device(device).type)


@functools.lru_cache(maxsize=4096)
def _design_energy(granularity, fmt_x, fmt_w, n_r, n_cols, seed, n_c,
                   device_type) -> dict:
    arch = design_arch(granularity, fmt_x)
    # gr_int reuses the gr_unit solve: an INT input carries one exponent bin
    solver = {"conv": "conv", "gr_int": "gr_unit"}.get(arch, arch)
    res = solve_required_enob(solver, fmt_x, n_r, fmt_w, n_cols, seed,
                              device=device_type)
    e = energy_per_op_fj(CimDesign(arch, fmt_x, fmt_w, res.enob, n_r, n_c),
                         TechParams())
    res_c = solve_required_enob("conv", fmt_x, n_r, fmt_w, n_cols, seed,
                                device=device_type)
    e_c = energy_per_op_fj(
        CimDesign("conv", fmt_x, fmt_w, res_c.enob, n_r, n_c), TechParams())
    return {
        "arch": arch,
        "fj_per_op": e.total,
        "enob": float(res.enob),
        "breakdown": e.as_dict(),
        "conv_fj_per_op": e_c.total,
        "conv_enob": float(res_c.enob),
    }


def price_ledger(ledger: CostLedger, tokens: int, *, seed: int = 0,
                 n_cols: int = 1 << 11, device=None) -> dict:
    """Price ``ledger × energy_per_op_fj(site design)`` and normalize by
    ``tokens``. Digital (mode "off") sites contribute op counts but no
    analog energy; pJ/token sums over analog sites only."""
    sites: Dict[str, dict] = {}
    pj_total = 0.0
    pj_conv = 0.0
    analog_ops = 0
    for entry, count in ledger.entries():
        ops = 2 * entry.macs * count
        s = sites.setdefault(entry.site, {
            "ops_per_token": 0.0, "analog_ops_per_token": 0.0,
            "pj_per_token": 0.0, "mode": entry.mode,
            "granularity": entry.granularity, "fmt_x": entry.fmt_x.name,
            "fmt_w": entry.fmt_w.name, "n_r": entry.n_r,
        })
        s["ops_per_token"] += ops / tokens
        if not entry.analog:
            continue
        pt = design_energy_fj(entry.granularity, entry.fmt_x, entry.fmt_w,
                              entry.n_r, n_cols=n_cols, seed=seed,
                              device=device)
        s["analog_ops_per_token"] += ops / tokens
        s["pj_per_token"] += ops / tokens * pt["fj_per_op"] * 1e-3
        s["fj_per_op"] = pt["fj_per_op"]
        s["enob"] = pt["enob"]
        s["design"] = pt["arch"]
        analog_ops += ops
        pj_total += ops * pt["fj_per_op"] * 1e-3
        pj_conv += ops * pt["conv_fj_per_op"] * 1e-3
    return {
        "tokens": tokens,
        "macs_per_token": ledger.macs() // tokens
        if ledger.macs() % tokens == 0 else ledger.macs() / tokens,
        "ops_per_token": 2 * ledger.macs() / tokens,
        "analog_ops_per_token": analog_ops / tokens,
        "pj_per_token": pj_total / tokens,
        "conventional_pj_per_token": pj_conv / tokens,
        "fj_per_op": (pj_total / analog_ops * 1e3) if analog_ops else 0.0,
        "conventional_fj_per_op":
            (pj_conv / analog_ops * 1e3) if analog_ops else 0.0,
        "sites": sites,
    }


def phase_report(arch, *, batch: int = 1, prefill_bucket: int = 128,
                 train_seq: Optional[int] = None, seed: int = 0,
                 n_cols: int = 1 << 11, device=None) -> dict:
    """Per-phase (prefill / decode / train) energy report for one arch:
    trace the model functions, price per site, normalize per token."""
    decode = trace_decode(arch, batch=batch)
    prefill = trace_prefill(arch, bucket=prefill_bucket, batch=batch)
    train = trace_train(arch, batch=batch, seq_len=train_seq)
    train_tokens = batch * (train_seq or default_train_seq(arch))
    kw = dict(seed=seed, n_cols=n_cols, device=device)
    return {
        "decode": price_ledger(decode, batch, **kw),
        "prefill": price_ledger(prefill, batch * prefill_bucket, **kw),
        "train": price_ledger(train, train_tokens, **kw),
    }
