"""Named scopes: the port's counterpart of ``jax.named_scope`` markers.

The kernels and models stamp every contraction with the scope it belongs
to: a ``cim_<site>_m<M>_k<K>_n<N>`` ledger contract
(``kernels.ops.site_marker``) with ``cim_values`` / ``cim_gains`` inside
it, or a declared-digital ``dig_*`` scope (``dig_attn``, ``dig_ssm_ssd``,
``dig_ste_bwd``). ``analysis.op_audit`` reads the stack while it watches
the aten operations a traced function issues.

The stack is a thread-local list of names. Entering a scope is one append
and leaving it one pop: no tensor, no CUDA launch, no profiler event
(``torch.profiler.record_function`` would cost far more on the hot path).
"""
from __future__ import annotations

import threading
from typing import List

__all__ = ["named_scope", "current"]

_TLS = threading.local()


def current() -> List[str]:
    """This thread's scope stack, outermost first (the live list)."""
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


class named_scope:
    """``with named_scope(name):`` pushes ``name`` for the block."""

    __slots__ = ("name", "_stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self._stack = current()
        self._stack.append(self.name)

    def __exit__(self, *exc) -> None:
        self._stack.pop()
