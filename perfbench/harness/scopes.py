"""The program's scopes in a profiler's trace. The port's ``core.scopes``
opens one ``record_function`` a scope while a profiler records, so its
layer boundaries are user annotations on the clock of the device's
intervals; this module reads them.

Two readings:

* host seconds in a scope: (``interval``, ``inside``, ``holding``,
  ``uncovered``) on
  the ``(start, end, name)`` host events of ``trace.Trace`` (serving runs
  its host work on one thread), and ``Scopes.host_seconds``: total and
  self time (the duration less its child scopes') of each scope name;
* device seconds put down to a scope (``Scopes``): each device operation
  is paired with the runtime call that launched it by the profiler's
  correlation id and put down to the innermost scope open on the
  launching thread at the launch, or to ``NO_SCOPE``. Every operation lands in exactly one, so
  the seconds put down add up to the device's total.

Scopes nest per thread: autograd's backward runs on a thread of its own,
with a stack of its own. Times are the profiler's, in us.
"""
from __future__ import annotations

import bisect
import re
from typing import NamedTuple

NO_SCOPE = "no scope"
# a site marker's shape suffix (``cim_mlp_m8_k768_n3072``): one name a site
SHAPE = re.compile(r"_m\d+_k\d+_n\d+$")
LABEL_CHARS = 160


class Host(NamedTuple):
    """A host event: ``kind`` "scope" (the program's), "span" (the
    benchmark's), "launch" (a CUDA runtime or driver call; ``corr`` its
    correlation id) or "op" (any other)."""
    start: float
    end: float
    name: str
    thread: int
    kind: str
    corr: int = 0


class Device(NamedTuple):
    """A device operation: ``corr`` the correlation id of its runtime
    call."""
    start: float
    end: float
    name: str
    corr: int


def site(name: str) -> str:
    """A scope's name with a site marker's shape suffix dropped."""
    return SHAPE.sub("", name)


def interval(events, prefix: str) -> list:
    """(start, end) of the host events whose name starts with ``prefix``,
    in order of start."""
    return sorted((s, e) for s, e, n in events if n.startswith(prefix))


def _enclosing(inner: list, outer: list) -> list:
    """(inner interval, index of the ``outer`` interval holding it) for
    each of ``inner`` that one of ``outer`` (sorted, not overlapping one
    another) holds."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in inner:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and e <= outer[j][1]:
            out.append(((s, e), j))
    return out


def inside(inner: list, outer: list) -> list:
    """The intervals of ``inner`` that lie inside one of ``outer``'s."""
    return [iv for iv, _ in _enclosing(inner, outer)]


def holding(outer: list, inner: list) -> list:
    """The intervals of ``outer`` that hold one of ``inner``'s or more."""
    return [outer[j] for j in sorted({j for _, j in _enclosing(inner,
                                                                outer)})]


def uncovered(outer: tuple, inner: list) -> float:
    """The length of ``outer`` that no interval of ``inner`` covers."""
    a, b = outer
    covered, reach = 0.0, a
    for s, e in sorted(inner):
        s, e = max(s, reach), min(e, b)
        if e > s:
            covered += e - s
            reach = e
    return (b - a) - covered


def mean_ms(intervals: list):
    """The mean length of ``intervals`` in ms (us in), None if none."""
    if not intervals:
        return None
    return 1e-3 * sum(e - s for s, e in intervals) / len(intervals)


class Scopes:
    """The scopes of a trace with their nesting, the device's operations
    put down to them, and labels of host moments."""

    def __init__(self, host, device=()):
        self.scopes = sorted((h for h in host if h.kind == "scope"),
                             key=lambda h: (h.thread, h.start, -h.end))
        self.spans = sorted((h for h in host if h.kind == "span"),
                            key=lambda h: h.start)
        self.ops = sorted((h for h in host if h.kind in ("op", "launch")),
                          key=lambda h: h.start)
        self.launch = {h.corr: h for h in host if h.kind == "launch"}
        self.device = list(device)
        # each scope's enclosing scope on its thread (-1: none)
        self.parent, stack = [], []
        for i, h in enumerate(self.scopes):
            while stack and (self.scopes[stack[-1]].thread != h.thread
                             or self.scopes[stack[-1]].end < h.end):
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self._keys = [(h.thread, h.start) for h in self.scopes]
        self._span_starts = [h.start for h in self.spans]
        self._op_starts = [h.start for h in self.ops]

    @classmethod
    def from_profiler(cls, events, spans) -> "Scopes":
        """From ``prof.events()``: the user annotations not named in
        ``spans`` are the program's scopes, the host events named ``cu*``
        the runtime's and driver's calls; a device operation carries the
        correlation id of the call that launched it as its ``id``."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        host, device = [], []
        for e in events:
            r = e.time_range
            if e.device_type == cuda:
                # the device operations ``trace.Trace`` takes
                if not (getattr(e, "is_user_annotation", False)
                        or e.name in spans):
                    device.append(Device(r.start, r.end, e.name, e.id))
                continue
            kind = ("span" if e.name in spans else
                    "scope" if getattr(e, "is_user_annotation", False) else
                    "launch" if e.name.startswith("cu") else "op")
            host.append(Host(r.start, r.end, e.name, e.thread, kind, e.id))
        return cls(host, device)

    def innermost(self, t: float, thread: int) -> int:
        """The index of the innermost scope open on ``thread`` at ``t``,
        -1 if none."""
        i = bisect.bisect_right(self._keys, (thread, t)) - 1
        while i >= 0:
            h = self.scopes[i]
            if h.thread != thread:
                return -1
            if h.start <= t <= h.end:
                return i
            i = self.parent[i]
        return -1

    def chain(self, i: int) -> list:
        """Scope ``i``'s name and its enclosing scopes', outermost first."""
        out = []
        while i >= 0:
            out.append(site(self.scopes[i].name))
            i = self.parent[i]
        return out[::-1]

    def host_seconds(self) -> dict:
        """Per scope name: [total s, self s, count]; self time is the
        duration less the part its child scopes cover."""
        child = [0.0] * len(self.scopes)
        for i, p in enumerate(self.parent):
            if p >= 0:
                h = self.scopes[i]
                child[p] += h.end - h.start
        out = {}
        for i, h in enumerate(self.scopes):
            row = out.setdefault(site(h.name), [0.0, 0.0, 0])
            row[0] += 1e-6 * (h.end - h.start)
            row[1] += 1e-6 * (h.end - h.start - child[i])
            row[2] += 1
        return out

    def owner(self, d: Device) -> int:
        """The innermost scope open where device operation ``d`` was
        launched, -1 for none (or no launch found)."""
        h = self.launch.get(d.corr)
        return -1 if h is None else self.innermost(h.start, h.thread)

    def device_by_scope(self) -> dict:
        """Device seconds by innermost scope name (``NO_SCOPE`` for the
        rest): every operation once."""
        out = {}
        for d in self.device:
            i = self.owner(d)
            name = site(self.scopes[i].name) if i >= 0 else NO_SCOPE
            out[name] = out.get(name, 0.0) + 1e-6 * (d.end - d.start)
        return out

    def device_seconds(self, name: str, under: str = "") -> float:
        """Device seconds put down to scope ``name`` where one of its
        enclosing scopes starts with ``under`` (any, if empty)."""
        total = 0.0
        for d in self.device:
            i = self.owner(d)
            if i < 0 or site(self.scopes[i].name) != name:
                continue
            if under and not any(n.startswith(under)
                                 for n in self.chain(i)[:-1]):
                continue
            total += 1e-6 * (d.end - d.start)
        return total

    def label(self, t: float) -> str:
        """What the host was doing at ``t``: the benchmark's span, the
        program's scopes open on the thread of the innermost host
        operation (or of the span), outermost first, and that operation,
        at most ``LABEL_CHARS`` characters."""
        j = bisect.bisect_right(self._span_starts, t) - 1
        span = self.spans[j] if j >= 0 and self.spans[j].end >= t else None
        k = bisect.bisect_right(self._op_starts, t)
        op = min((o for o in self.ops[max(0, k - 4000):k] if o.end >= t),
                 key=lambda o: o.end - o.start, default=None)
        thread = op.thread if op else span.thread if span else None
        scopes = (self.chain(self.innermost(t, thread))
                  if thread is not None else [])
        text = span.name if span else "outside the spans"
        if scopes:
            text += ": " + " > ".join(scopes)
        if op:
            text += ": " + op.name
        return text[:LABEL_CHARS]
