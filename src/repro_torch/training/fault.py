"""Failure and straggler detection from heartbeats; the port's counterpart
of the detection half of ``repro.training.fault``.

A host that stops heartbeating has failed; one that heartbeats with a step
time well above the fleet's median straggles. The board is a directory of
one JSON file per host, written atomically. (The reference's elastic
re-meshing and fault-injection plans belong with the parallel slice.)
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

__all__ = ["Heartbeat", "HeartbeatBoard", "detect_failures",
           "detect_stragglers"]


@dataclasses.dataclass
class Heartbeat:
    host: int
    step: int
    t_wall: float
    step_time_s: float


class HeartbeatBoard:
    """File-backed heartbeat board (one JSON file per host)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, host: int) -> str:
        return os.path.join(self.dir, f"host_{host:05d}.json")

    def beat(self, hb: Heartbeat) -> None:
        path = self._path(hb.host)
        with open(path + ".tmp", "w") as f:
            json.dump(dataclasses.asdict(hb), f)
        os.replace(path + ".tmp", path)

    def read_all(self) -> List[Heartbeat]:
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("host_") and fn.endswith(".json"):
                try:
                    with open(os.path.join(self.dir, fn)) as f:
                        out.append(Heartbeat(**json.load(f)))
                except (json.JSONDecodeError, TypeError):
                    continue  # a torn write: missing this round
        return out

    def clear(self, host: int) -> None:
        """Drop a host's file (a decommissioned host stops counting)."""
        if os.path.exists(self._path(host)):
            os.remove(self._path(host))


def detect_failures(beats: List[Heartbeat], now: float,
                    timeout_s: float = 60.0,
                    expected_hosts: Optional[int] = None) -> List[int]:
    """Hosts that have not heartbeat within ``timeout_s`` (and, given
    ``expected_hosts``, those never seen)."""
    seen = {b.host: b for b in beats}
    dead = [h for h, b in seen.items() if now - b.t_wall > timeout_s]
    if expected_hosts is not None:
        dead += [h for h in range(expected_hosts) if h not in seen]
    return sorted(set(dead))


def detect_stragglers(beats: List[Heartbeat],
                      factor: float = 2.0) -> List[int]:
    """Hosts whose step time exceeds ``factor`` x the fleet median (none
    with fewer than three hosts)."""
    if len(beats) < 3:
        return []
    med = float(np.median([b.step_time_s for b in beats]))
    return sorted(b.host for b in beats if b.step_time_s > factor * med)
