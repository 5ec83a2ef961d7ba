"""Supervised fault drills: deterministic failure injection, detection,
recovery and measured GoodPut for the training loop; the port's
counterpart of ``repro.training.supervisor``.

``Supervisor.run_drill`` runs training under a seeded ``FaultPlan``
(``fault.FAULT_KINDS``):

* **kill**: the training process dies at a step boundary. Its host stops
  heartbeating; the supervisor detects it (``detect_failures`` over the
  simulated fleet's board), restarts and restores the freshest checkpoint
  across tiers (the node survived: the fast **local** tier counts);
* **device_loss**: a worker host's chips drop out for good, its
  node-local tier with them (``AsyncCheckpointer.invalidate_local``), so
  restore falls back to the **durable** tier, and the run resumes
  elastically: ``plan_remesh`` shrinks the data-parallel width to the
  surviving chips (the *logical* width, in the report);
* **straggler**: a host steps ``severity`` times slower; detected by
  ``detect_stragglers`` against the fleet median, no restart.

After every restore the state is placed on the physical mesh, the devices
this process has (1 x 1: the card on a world-1 NCCL group, or the CPU on
a world-1 gloo group), as DTensors: ``parallel.sharding.param_specs``
lays it out and ``fault.reshard_tree`` places it. The train step runs
under that mesh (``sharding.use_mesh``).

Determinism contract: faults fire at scheduled steps of a deterministic
loop; the fleet's board runs on a virtual clock (1.0 a step), so
detection takes a machine-independent number of monitoring rounds; the
asynchronous writer is drained at every fault boundary. Hence faults
injected and detected, checkpoints and restores per tier, steps
recomputed, remesh events, dp widths and the final step are pure
functions of (plan, config), equal to the reference's for the same plan.
The (seed, step)-pure data pipeline and the exact round trip of the
checkpoint format make a recomputed step's loss bitwise equal to its
first run, which ``run_drill`` asserts on every recomputed step.

``GoodPutLedger`` partitions wall time; each instant belongs to exactly
one bucket: ``productive`` (first-time steps, the only GoodPut),
``recompute``, ``checkpoint_stall`` (the training thread's snapshot and
enqueue, and the drains at fault boundaries), ``detection``,
``recovery`` (restore and re-shard), ``overhead``.
``goodput_pct = 100 x productive / wall``. ``price_drill`` prices the
BadPut through the port's cost ledger: pJ per useful token = pJ/token x
tokens computed / tokens useful.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import require_full_f32, resolve_device
from repro_torch.models import init_params
from repro_torch.parallel import sharding
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault import (FaultPlan, Heartbeat, HeartbeatBoard,
                                        detect_failures, detect_stragglers,
                                        plan_remesh, reshard_tree)
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.trainer import TrainConfig, make_train_step

__all__ = ["DrillConfig", "GoodPutLedger", "SimFleet", "Supervisor",
           "price_drill"]


# ---------------------------------------------------------------- ledger
class GoodPutLedger:
    """Wall-time partition and deterministic counters (module docstring).
    Exactly one bucket is current at any instant; ``to`` / ``in_bucket``
    switch it and ``close`` flushes the tail, so the buckets sum to the
    wall clock. ``clock`` is injectable for deterministic tests."""

    BUCKETS = ("productive", "recompute", "checkpoint_stall",
               "detection", "recovery", "overhead")

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.buckets: Dict[str, float] = {b: 0.0 for b in self.BUCKETS}
        self.counters: Dict[str, int] = {}
        self._cur = "overhead"
        self._t0: Optional[float] = None
        self._t_mark: Optional[float] = None
        self._wall: Optional[float] = None

    def start(self) -> "GoodPutLedger":
        self._t0 = self._t_mark = self._clock()
        return self

    def to(self, bucket: str) -> str:
        """Switch the current bucket; returns the previous one."""
        if bucket not in self.buckets:
            raise KeyError(f"unknown bucket {bucket!r}")
        if self._t_mark is None:
            raise RuntimeError("GoodPutLedger.start() was never called")
        now = self._clock()
        self.buckets[self._cur] += now - self._t_mark
        self._t_mark = now
        prev, self._cur = self._cur, bucket
        return prev

    @contextmanager
    def in_bucket(self, bucket: str):
        prev = self.to(bucket)
        try:
            yield self
        finally:
            self.to(prev)

    def inc(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def close(self) -> float:
        if self._wall is None:
            self.to(self._cur)           # flush the tail interval
            self._wall = self._t_mark - self._t0
        return self._wall

    @property
    def wall_s(self) -> float:
        if self._wall is not None:
            return self._wall
        return self._clock() - self._t0

    @property
    def goodput_frac(self) -> float:
        return self.buckets["productive"] / max(self.wall_s, 1e-12)

    def report(self) -> dict:
        return {"wall_s": self.wall_s,
                "goodput_pct": 100.0 * self.goodput_frac,
                "buckets_s": dict(self.buckets),
                "counters": dict(self.counters)}


# ----------------------------------------------------------------- fleet
class SimFleet:
    """A deterministic simulated fleet around the one real process: host
    0 is the trainer, hosts 1..n-1 synthetic peers beating nominal step
    times on a virtual clock (1.0 a step). While a detection loop runs
    the survivors keep beating, so only dead hosts age out."""

    def __init__(self, board: HeartbeatBoard, n_hosts: int,
                 chips_per_host: int, timeout_s: float = 3.0):
        self.board = board
        self.chips_per_host = chips_per_host
        self.timeout_s = timeout_s
        self.healthy = set(range(n_hosts))
        self.t = 0.0
        self.last_step = 0

    @property
    def n_chips(self) -> int:
        return len(self.healthy) * self.chips_per_host

    def beat_all(self, step: int,
                 step_times: Optional[Dict[int, float]] = None) -> None:
        st = step_times or {}
        for h in self.healthy:
            self.board.beat(Heartbeat(h, step, self.t, st.get(h, 1.0)))
        self.last_step = step

    def tick(self, dt: float = 1.0) -> None:
        self.t += dt

    def kill(self, host: int) -> None:
        self.healthy.discard(host)

    def revive(self, host: int) -> None:
        self.healthy.add(host)

    def decommission(self, host: int) -> None:
        self.board.clear(host)

    def detect_dead(self) -> List[int]:
        """Monitoring rounds until ``detect_failures`` reports a host; it
        fires after ``floor(timeout_s) + 1`` rounds."""
        deadline = self.t + 10.0 * (self.timeout_s + 1.0)
        while self.t < deadline:
            self.tick()
            for h in self.healthy:
                self.board.beat(Heartbeat(h, self.last_step, self.t, 1.0))
            dead = detect_failures(self.board.read_all(), self.t,
                                   timeout_s=self.timeout_s)
            if dead:
                return dead
        raise RuntimeError("injected failure was never detected")


# ------------------------------------------------------------ supervisor
@dataclasses.dataclass(frozen=True)
class DrillConfig:
    """Drill parameters. ``workdir`` roots the checkpoint tiers (``local/``,
    ``durable/``) and the heartbeat board; the tiers' cadences are
    ``local_every`` and ``durable_every``."""
    workdir: str
    steps: int = 12
    local_every: int = 2
    durable_every: int = 6
    keep_local: int = 2
    keep_durable: int = 3
    n_hosts: int = 4
    n_chips: int = 8
    model_parallel: int = 1
    pod_size: int = 256
    heartbeat_timeout: float = 3.0
    straggler_factor: float = 2.0

    @property
    def local_dir(self) -> str:
        return os.path.join(self.workdir, "local")

    @property
    def durable_dir(self) -> str:
        return os.path.join(self.workdir, "durable")

    @property
    def heartbeat_dir(self) -> str:
        return os.path.join(self.workdir, "heartbeats")


class Supervisor:
    """Runs training under a ``FaultPlan`` and closes the loop: inject,
    detect, restore from the freshest tier, (elastically) resume, every
    wall second bucketed in a ``GoodPutLedger``.

    ``params`` seeds the run with given weights (a copy of the reference's
    for parity); by default they are ``init_params(arch, seed)`` on
    ``device`` (None: the card)."""

    def __init__(self, arch: ArchConfig, tcfg: TrainConfig,
                 dcfg: DrillConfig, pipeline, plan: FaultPlan, *,
                 seed: int = 0, params: Optional[dict] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if dcfg.n_chips % dcfg.n_hosts != 0:
            raise ValueError("n_chips must divide evenly over n_hosts")
        self.arch, self.tcfg, self.dcfg = arch, tcfg, dcfg
        self.pipeline, self.plan, self.seed = pipeline, plan, seed
        self.params = params
        self.device = resolve_device(device)

    def _dp_width(self, n_chips: int) -> int:
        shape, axes = plan_remesh(n_chips, self.dcfg.model_parallel,
                                  self.dcfg.pod_size)
        return int(np.prod([s for s, a in zip(shape, axes) if a != "model"]))

    def run_drill(self) -> dict:
        """The drill on the active mesh, or on a 1 x 1 mesh of ``device``
        (``launch.mesh.local_mesh``) when none is active; on the card with
        deterministic algorithms on."""
        from repro_torch.launch.mesh import local_mesh

        mesh = sharding.get_mesh()
        ctx = nullcontext(mesh) if mesh is not None else local_mesh(
            self.device)
        # the recompute contract needs a deterministic backward on the card
        # (the embedding's gradient accumulates by index)
        deterministic = torch.are_deterministic_algorithms_enabled()
        warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
        if self.device.type == "cuda":
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with ctx as mesh, sharding.use_mesh(mesh):
                return self._run(mesh)
        finally:
            torch.use_deterministic_algorithms(deterministic,
                                               warn_only=warn_only)

    def _run(self, mesh) -> dict:
        dcfg, tcfg = self.dcfg, self.tcfg
        if self.device.type == "cuda":
            require_full_f32()
        led = GoodPutLedger().start()
        board = HeartbeatBoard(dcfg.heartbeat_dir)
        fleet = SimFleet(board, dcfg.n_hosts, dcfg.n_chips // dcfg.n_hosts,
                         timeout_s=dcfg.heartbeat_timeout)
        writer = ckpt.AsyncCheckpointer(
            dcfg.durable_dir, dcfg.local_dir,
            durable_every=dcfg.durable_every, local_every=dcfg.local_every,
            keep_durable=dcfg.keep_durable, keep_local=dcfg.keep_local)

        params = (self.params if self.params is not None
                  else init_params(self.arch, self.seed, device=self.device))
        state = {"params": params, "opt": init_opt_state(params, tcfg.opt)}
        step_fn = make_train_step(self.arch, tcfg)
        dp_initial = self._dp_width(fleet.n_chips)
        dp_width = dp_initial

        # a durable floor: a fault before the first cadence save still has
        # something to recover to (step 0 recomputes from the init)
        with led.in_bucket("checkpoint_stall"):
            writer.save(0, state, ("durable",))

        events = deque(self.plan.events)
        losses: Dict[int, float] = {}
        high_water = 0     # furthest step ever completed (+1)
        start = 0
        attempts = 0
        try:
            while True:
                attempts += 1
                aborted = None
                for step in range(start, dcfg.steps):
                    ev = events[0] if events else None
                    if ev and ev.step == step and ev.kind in ("kill",
                                                              "device_loss"):
                        events.popleft()
                        led.inc("faults_injected")
                        led.inc(f"fault_{ev.kind}")
                        # quiesce the writer at the fault boundary, so the
                        # per-tier counts cannot race the fault
                        with led.in_bucket("checkpoint_stall"):
                            writer.drain()
                        aborted = ev
                        break

                    recompute = step < high_water
                    if recompute:
                        led.inc("steps_recomputed")
                    with led.in_bucket("recompute" if recompute
                                       else "productive"):
                        batch = self.pipeline.batch_at(step)
                        p, o, m = step_fn(state["params"], state["opt"],
                                          batch)
                        loss = float(m["loss"])        # waits for the step
                    state = {"params": p, "opt": o}
                    if step in losses and losses[step] != loss:
                        raise AssertionError(
                            f"recomputed step {step} diverged from its first "
                            f"run: {losses[step]!r} vs {loss!r}; the (seed, "
                            "step)-pure resume contract is broken")
                    losses[step] = loss

                    step_times = {0: 1.0}
                    if ev and ev.step == step and ev.kind == "straggler":
                        events.popleft()
                        led.inc("faults_injected")
                        led.inc("fault_straggler")
                        # the trainer reports a severity-times step time;
                        # detection is against the fleet median
                        step_times[0] = float(ev.severity)
                        with led.in_bucket("detection"):
                            fleet.beat_all(step, step_times)
                            slow = detect_stragglers(
                                board.read_all(),
                                factor=dcfg.straggler_factor)
                            if 0 in slow:
                                led.inc("faults_detected")
                                led.inc("stragglers_detected")
                    else:
                        fleet.beat_all(step, step_times)
                    fleet.tick()
                    high_water = max(high_water, step + 1)
                    with led.in_bucket("checkpoint_stall"):
                        writer.maybe_save(step + 1, state)

                if aborted is None:
                    break   # drill complete

                # ------------- failure handling: detect, then recover
                if aborted.kind == "kill":
                    killed = [0]
                else:
                    # device loss takes out the highest-numbered survivors
                    survivors = sorted(h for h in fleet.healthy if h != 0)
                    killed = survivors[-aborted.severity:]
                for h in killed:
                    fleet.kill(h)
                with led.in_bucket("detection"):
                    dead = fleet.detect_dead()
                    if set(killed) <= set(dead):
                        led.inc("faults_detected")

                with led.in_bucket("recovery"):
                    if aborted.kind == "device_loss":
                        for h in killed:
                            fleet.decommission(h)
                        # the node-local tier died with the node
                        writer.invalidate_local()
                        dp_width = self._dp_width(fleet.n_chips)
                        led.inc("remesh_events")
                        include_local = False
                    else:
                        fleet.revive(0)   # the killed trainer restarts
                        include_local = True
                    restored, rstep, tier = writer.restore(
                        state, include_local=include_local)
                    led.inc(f"restore_{tier}")
                    specs = {k: sharding.param_specs(restored[k], mesh)
                             for k in restored}
                    state = reshard_tree(restored, mesh, specs)
                    start = rstep

            with led.in_bucket("checkpoint_stall"):
                writer.save(dcfg.steps, state, ("durable",))
                writer.drain()
        finally:
            writer.close()
        led.close()

        c = led.counters.get
        return {
            "final_step": high_water,
            "attempts": attempts,
            "faults_injected": c("faults_injected", 0),
            "faults_detected": c("faults_detected", 0),
            "fault_kill": c("fault_kill", 0),
            "fault_device_loss": c("fault_device_loss", 0),
            "fault_straggler": c("fault_straggler", 0),
            "steps_recomputed": c("steps_recomputed", 0),
            "ckpt_local": writer.stats["local"],
            "ckpt_durable": writer.stats["durable"],
            "restore_local": c("restore_local", 0),
            "restore_durable": c("restore_durable", 0),
            "remesh_events": c("remesh_events", 0),
            "dp_width_initial": dp_initial,
            "dp_width_final": dp_width,
            "losses": [losses[s] for s in range(dcfg.steps)],
            "goodput": led.report(),
        }


# ----------------------------------------------------------------- energy
def price_drill(arch: ArchConfig, report: dict, *, tokens_per_step: int,
                seed: int = 0, n_cols: int = 1 << 8,
                device: Optional[Union[str, torch.device]] = None) -> dict:
    """Price a drill's BadPut through the cost ledger: recomputed steps
    add to the tokens computed (and their energy) but never to the tokens
    usefully trained on, so ``pj_per_useful_token = pj_per_token x
    computed / useful``. pJ/token is the train trace's of the arch's CIM
    deployment (``grmac`` when the arch serves digital), its Monte-Carlo
    solves drawn on ``device`` (None: the card)."""
    from repro_torch.core import costs

    cim_arch = arch if arch.cim.enabled else arch.replace(
        cim=arch.cim.with_mode("grmac"))
    ledger = costs.trace_train(cim_arch)
    trace_tokens = costs.default_train_seq(cim_arch)
    pj_tok = costs.price_ledger(ledger, trace_tokens, seed=seed,
                                n_cols=n_cols, device=device)["pj_per_token"]
    useful = report["final_step"] * tokens_per_step
    computed = (report["final_step"]
                + report["steps_recomputed"]) * tokens_per_step
    return {
        "tokens_useful": useful,
        "tokens_computed": computed,
        "pj_per_token": pj_tok,
        "pj_per_useful_token": pj_tok * computed / max(useful, 1),
        "badput_energy_overhead": computed / max(useful, 1),
    }
