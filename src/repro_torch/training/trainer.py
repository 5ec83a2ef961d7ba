"""The train step and the resilient training loop; the port's counterpart
of ``repro.training.trainer``.

``make_train_step`` builds a (params, opt_state, batch) -> (params,
opt_state, metrics) function: the loss's gradients by autograd (the CIM
projections' backward is the STE's exact matmul), microbatches
accumulated in f32 (gradients and the whole metrics dict, each divided by
their count as they arrive), optional int8 error-feedback compression,
then the optimizer. It does not change its inputs: parameters come back
as new tensors.

On the card every GR-MAC projection of the forward (and of its
recomputation under ``remat``) runs the kernel's per-call route: the raw
weight is pre-scaled, quantized and packed on every call (a packed
weight has no gradient).

``train`` is the driver: restore-or-init, heartbeats, periodic
asynchronous checkpoints, a log line every ``log_every`` steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import require_full_f32, resolve_device
from repro_torch.core.scopes import named_scope
from repro_torch.models import init_params, train_loss
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.fault import Heartbeat, HeartbeatBoard
from repro_torch.training.optimizer import (OptimizerConfig, apply_updates,
                                            compress_grads, decompress_grads,
                                            init_opt_state)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TrainConfig", "make_train_step", "train"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatches: int = 1
    # durable checkpoint tier, written asynchronously every ckpt_every steps
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    # optional fast local tier; None disables it
    ckpt_local_dir: Optional[str] = None
    ckpt_local_every: int = 10
    log_every: int = 10
    # GR-MAC backend override for CIM-enabled archs: None keeps the arch's
    # CIMConfig.backend; "ref" runs the plain version on the card too
    cim_backend: Optional[str] = None
    opt: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def make_train_step(arch: ArchConfig, tcfg: TrainConfig) -> Callable:
    if tcfg.cim_backend is not None:
        arch = arch.replace(cim=arch.cim.with_backend(tcfg.cim_backend))
    ocfg, nmb = tcfg.opt, tcfg.microbatches

    def grads_of(params, batch):
        with named_scope("train.forward"):
            leaves = tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
            total, metrics = train_loss(leaves, batch, arch)
        with named_scope("train.backward"):
            grads = torch.autograd.grad(total, tree_leaves(leaves),
                                        materialize_grads=True)
        it = iter(grads)
        return (tree_map(lambda _: next(it), params),
                {k: v.detach() for k, v in metrics.items()})

    def train_step(params, opt_state, batch):
        if nmb == 1:
            grads, metrics = grads_of(params, batch)
        else:
            # zeros_like: a DTensor parameter's sum keeps its placement
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            metrics = None
            for i in range(nmb):
                mb = {k: v.chunk(nmb, dim=0)[i] for k, v in batch.items()}
                g, m = grads_of(params, mb)
                grads = tree_map(lambda a, b: a + b.to(torch.float32) / nmb,
                                 grads, g)
                # the whole metrics dict: an MoE aux loss survives
                metrics = {k: (0 if metrics is None else metrics[k])
                           + v / nmb for k, v in m.items()}
        with named_scope("train.optimizer"):
            if ocfg.grad_compression:
                q, scales, err = compress_grads(grads, opt_state["err"])
                grads = decompress_grads(q, scales)
                opt_state = dict(opt_state, err=err)
            params, opt_state, om = apply_updates(params, grads, opt_state,
                                                  ocfg)
        return params, opt_state, dict(metrics, **om)

    return train_step


def train(arch: ArchConfig, tcfg: TrainConfig, pipeline, *, seed: int = 0,
          heartbeat_dir: Optional[str] = None,
          device: Optional[Union[str, torch.device]] = None) -> dict:
    """Run (or resume) training on ``device`` (None: the card); returns the
    last step's metrics as floats, by name in sorted order (as the
    reference's jitted step returns them). With ``ckpt_dir`` set it
    resumes from the freshest valid checkpoint of either tier and saves
    asynchronously; the last step is always saved to the durable tier."""
    device = resolve_device(device)
    if device.type == "cuda":
        require_full_f32()
    params = init_params(arch, seed, device=device)
    opt_state = init_opt_state(params, tcfg.opt)
    start_step = 0
    writer = None
    if tcfg.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(
            tcfg.ckpt_dir, tcfg.ckpt_local_dir,
            durable_every=tcfg.ckpt_every, local_every=tcfg.ckpt_local_every)
        try:
            state, start_step, tier = writer.restore(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"[train] resumed from step {start_step} ({tier} tier)")
        except FileNotFoundError:
            pass  # cold start
    step_fn = make_train_step(arch, tcfg)
    board = HeartbeatBoard(heartbeat_dir) if heartbeat_dir else None
    metrics = {}
    try:
        for step in range(start_step, tcfg.steps):
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 pipeline.batch_at(step))
            loss = float(metrics["loss"])       # waits for the step
            dt = time.time() - t0
            if board:
                board.beat(Heartbeat(0, step, time.time(), dt))
            if step % tcfg.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if writer:
                writer.maybe_save(step + 1, {"params": params,
                                             "opt": opt_state})
        if writer:
            writer.save(tcfg.steps, {"params": params, "opt": opt_state})
    finally:
        if writer:
            writer.close()
    return {k: float(v) for k, v in sorted(metrics.items())}
