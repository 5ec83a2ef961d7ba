"""Fault tolerance: heartbeat-based failure and straggler detection,
elastic re-meshing and seeded fault-injection plans; the port's
counterpart of ``repro.training.fault``.

A host that stops heartbeating has failed; one that heartbeats with a step
time well above the fleet's median straggles. The board is a directory of
one JSON file per host, written atomically.

Elastic policy: on node loss, shrink the data-parallel axis to the
largest feasible size (``plan_remesh``), place the latest checkpoint on
the surviving mesh (``reshard_tree``: DTensors by ``distribute_tensor``)
and resume from its step; the data pipeline is (seed, step)-pure, so no
input state is lost.

``FaultPlan`` is the injection side: a deterministic schedule of faults
(process kill, device loss, straggler) that ``training.supervisor`` runs
against a live training loop. ``make_fault_plan`` draws it with
``np.random.RandomState``, as the reference does, so a seed gives both
packages the same plan.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Heartbeat", "HeartbeatBoard", "detect_failures",
           "detect_stragglers", "plan_remesh", "reshard_tree",
           "FAULT_KINDS", "FaultEvent", "FaultPlan", "make_fault_plan"]


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


def plan_remesh(n_healthy_chips: int, model_parallel: int,
                pod_size: int = 256
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The largest feasible mesh after failures: ``model_parallel`` kept
    (the parameter layout is unchanged, so the re-shard is cheap), data
    parallelism shrunk to the largest multiple that fits, single-pod axes
    when fewer than 2 pods survive."""
    if n_healthy_chips < model_parallel:
        raise RuntimeError("not enough chips for the model-parallel degree")
    data = n_healthy_chips // model_parallel
    pods = max(1, n_healthy_chips // pod_size)
    if pods >= 2 and data % pods == 0:
        return (pods, data // pods, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")


def reshard_tree(tree, mesh, spec_tree):
    """Place a tree (numpy arrays or tensors, the same on every rank) onto
    ``mesh``: each leaf a DTensor by ``distribute_tensor`` with the
    placements of its spec (``parallel.sharding.placements``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.parallel.sharding import placements
    from repro_torch.tree import tree_map

    def put(x, spec):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        x = x.detach().to(mesh.device_type)
        return distribute_tensor(x, mesh, placements(spec, mesh))

    return tree_map(put, tree, spec_tree)


# ------------------------------------------------------------ fault plans
#: The drill's fault taxonomy. "kill": the training process dies at a step
#: boundary and restarts on the same fleet (the node-local checkpoint tier
#: survives). "device_loss": a worker host's chips drop out for good, its
#: node-local tier with them, and the run resumes elastically at a smaller
#: data-parallel width from the durable tier. "straggler": a host keeps
#: stepping ``severity`` times slower; detection only, no restart.
FAULT_KINDS = ("kill", "device_loss", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault at training step ``step`` (kill and device loss
    fire before the step runs; a straggler slows the step itself).
    ``severity``: hosts lost for a device loss, the slowdown factor of a
    straggler."""
    step: int
    kind: str
    severity: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.step < 1:
            raise ValueError("faults fire at step >= 1 (step 0 has no "
                             "checkpoint to recover to but the init)")
        if self.severity < 1:
            raise ValueError("severity must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, step-ordered fault schedule, at most one fault a
    step; the supervisor injects each event once."""
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        steps = [e.step for e in self.events]
        if steps != sorted(steps):
            raise ValueError("FaultPlan events must be ordered by step")
        if len(set(steps)) != len(steps):
            raise ValueError("at most one fault per step")


def make_fault_plan(seed: int, steps: int, *, n_faults: int = 3,
                    kinds: Tuple[str, ...] = FAULT_KINDS,
                    min_gap: int = 2) -> FaultPlan:
    """A seeded drill schedule: ``n_faults`` events at distinct steps in
    [1, steps), at least ``min_gap`` apart, cycling through ``kinds`` in a
    seeded shuffle; stragglers at the canonical 4x slowdown (detectable at
    the default factor 2). ``np.random.RandomState`` draws in the
    reference's order, so the plan is the reference's."""
    candidates = list(range(1, steps))
    rng = np.random.RandomState(seed)
    chosen: List[int] = []
    rng.shuffle(candidates)
    for s in candidates:
        if all(abs(s - c) >= min_gap for c in chosen):
            chosen.append(s)
        if len(chosen) == n_faults:
            break
    if len(chosen) < n_faults:
        raise ValueError(f"cannot place {n_faults} faults with gap "
                         f"{min_gap} in {steps} steps")
    kind_seq = [kinds[i % len(kinds)] for i in range(n_faults)]
    rng.shuffle(kind_seq)
    return FaultPlan(tuple(
        FaultEvent(step=s, kind=k, severity=4 if k == "straggler" else 1)
        for s, k in zip(sorted(chosen), kind_seq)))
