"""The profiler's trace of a slice of the window, reduced once to what the
per-layer metrics read: device busy time (the union of every device
operation's interval), device time and count by kernel name, CUDA
launches inside the benchmark's spans (``record_function`` labels), the
operations that took most device time, and the longest idle gaps of the
device with what the host was doing in each."""
from __future__ import annotations

import bisect
import contextlib

import torch

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")


def span(name: str, on: bool):
    """A ``record_function`` label while tracing, else nothing."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Trace:
    """``spans``: the names of the driver's ``span`` labels."""

    def __init__(self, prof, window_s: float, spans: tuple):
        cuda = torch.autograd.DeviceType.CUDA
        dev, cpu = [], []
        for e in prof.events():
            r = e.time_range
            if getattr(e, "is_user_annotation", False) or e.name in spans:
                if e.device_type == cuda:
                    continue
            if e.device_type == cuda:
                dev.append((r.start, r.end, e.name))
            else:
                cpu.append((r.start, r.end, e.name))
        dev.sort()
        cpu.sort()
        self.window_s = window_s
        self.by_name: dict = {}
        for s, t, name in dev:
            tot, n = self.by_name.get(name, (0.0, 0))
            self.by_name[name] = (tot + (t - s) * 1e-6, n + 1)
        merged = []
        for s, t, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s = sum(t - s for s, t in merged) * 1e-6
        self._gaps = sorted(((merged[i + 1][0] - merged[i][1],
                              merged[i][1], merged[i + 1][0])
                             for i in range(len(merged) - 1)),
                            reverse=True)[:10]
        self._cpu = cpu
        self._starts = [c[0] for c in cpu]
        self._names = spans
        spans = [(s, t, n) for s, t, n in cpu if n in self._names]
        self._spans = spans
        self._span_starts = [s for s, _, _ in spans]
        launches = [s for s, _, n in cpu if n.startswith(LAUNCH_PREFIXES)]
        self.launches_total = len(launches)
        self.launches_in: dict = {}
        for s, t, n in spans:
            k = bisect.bisect_left(launches, s)
            j = bisect.bisect_right(launches, t)
            self.launches_in[n] = self.launches_in.get(n, 0) + (j - k)
        self.span_count = {}
        for _, _, n in spans:
            self.span_count[n] = self.span_count.get(n, 0) + 1

    def device_seconds(self, pattern: str):
        """(seconds, count) of the device operations whose name contains
        ``pattern``."""
        hits = [v for k, v in self.by_name.items() if pattern in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def _host_at(self, t: float) -> str:
        """The benchmark span and the innermost host operation at t."""
        label = "outside the spans"
        j = bisect.bisect_right(self._span_starts, t)
        if j and self._spans[j - 1][1] >= t:
            label = self._spans[j - 1][2]
        k = bisect.bisect_right(self._starts, t)
        inner = None
        for s, e, n in reversed(self._cpu[max(0, k - 4000):k]):
            if s <= t <= e and n not in self._names and (
                    inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, n)
        return f"{label}: {inner[2]}" if inner else label

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[k[:160], v[0]] for k, v in top],
                "idle_gaps": [[self._host_at((a + b) / 2), g * 1e-6]
                              for g, a, b in self._gaps]}
