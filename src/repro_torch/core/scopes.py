"""Named scopes: the port's counterpart of ``jax.named_scope`` markers,
and its spans on the profiler's clock.

The kernels and models stamp every contraction with the scope it belongs
to: a ``cim_<site>_m<M>_k<K>_n<N>`` ledger contract
(``kernels.ops.site_marker``) with ``cim_values`` / ``cim_gains`` inside
it, or a declared-digital ``dig_*`` scope (``dig_attn``, ``dig_ssm_ssd``,
``dig_ste_bwd``). ``analysis.op_audit`` reads the stack while it watches
the aten operations a traced function issues.

The layers stamp their boundaries with lowercase dotted scopes:
``sched.step`` and its phases (``sched.preempt``, ``sched.admit``,
``sched.prefill``, ``sched.decode``); the engine's dispatches
``engine.<key>`` (``engine.decode[sample=False]``,
``engine.prefill[bucket=128]``, ...), ``engine.fetch`` (the device-to-host
wait), ``engine.h2d`` (a host-to-device copy of lane state) and
``engine.choose``; the model's ``model.embed``, ``model.layer`` (each
block), ``model.head`` and ``attn.cache_write``; the SSM block's
``ssm.recurrence`` (a layer's prefill recurrence over the chunk),
``ssm.step`` (each time step of the plain loop, padded steps included,
and decode's one step) and ``ssm.scan`` (on the card, the one launch of
the scan that runs the recurrence over a dispatch); the CIM op's
``cim.prescale`` (the absmax of x) and ``cim.pack`` (a per-call weight
packing); the trainer's ``train.forward``, ``train.backward`` and
``train.optimizer``.

The stack is a thread-local list of names. Entering a scope is one append
and leaving it one pop, after one check of whether a ``torch.profiler``
records: only then does the scope also open a
``torch.profiler.record_function`` of its name, so that the profiler's
trace holds it as a user annotation on the clock of its device events.
Otherwise a scope issues no tensor, no CUDA launch and no dispatcher
operation. A scope entered in autograd's backward (remat's recomputation,
the STE backward) is on autograd's own thread, with a stack of its own.
"""
from __future__ import annotations

import threading
from typing import List

import torch

__all__ = ["named_scope", "current"]

_TLS = threading.local()
_profiling = torch.autograd._profiler_enabled


def current() -> List[str]:
    """This thread's scope stack, outermost first (the live list)."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class named_scope:
    """``with named_scope(name):`` pushes ``name`` for the block, and
    records it while a profiler records."""

    __slots__ = ("name", "_stack", "_span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._stack = current()
        self._stack.append(self.name)
        self._span = None
        if _profiling():
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()

    def __exit__(self, *exc) -> None:
        if self._span is not None:
            self._span.__exit__(*exc)
        self._stack.pop()
