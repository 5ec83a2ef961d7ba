"""The system under test, the port ``repro_torch``, built from a cell's
files: its configuration as the port's ``ArchConfig``, its serving
``Engine`` and ``Scheduler``, its train step. Imported only here and by
the drivers; the reference never imports it."""
from __future__ import annotations

import sys

from perfbench.harness.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.cim_config import CIMConfig  # noqa: E402
from repro_torch.core.formats import parse_format  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                prefill_step)
from repro_torch.serving import (Engine, SamplingParams,  # noqa: E402
                                 Scheduler, SchedulerConfig, ServeConfig)
from repro_torch.training.optimizer import (OptimizerConfig,  # noqa: E402
                                            init_opt_state)
from repro_torch.training.trainer import (TrainConfig,  # noqa: E402
                                          make_train_step)

__all__ = ["arch", "engine", "scheduler", "warm_serving", "SamplingParams",
           "train_step", "init_opt_state", "optimizer_config"]


def arch(config: dict) -> ArchConfig:
    a = dict(config["arch"], block_pattern=tuple(config["arch"][
        "block_pattern"]))
    c = config["cim"]
    return ArchConfig(**a, cim=CIMConfig(
        mode=c["mode"], granularity=c["granularity"],
        fmt_x=parse_format(c["fmt_x"]), fmt_w=parse_format(c["fmt_w"]),
        n_r=c["n_r"], enob=c["enob"]))


def engine(a: ArchConfig, params: dict, e: dict, device) -> Engine:
    return Engine(a, params, ServeConfig(
        batch_slots=e["batch_slots"], max_ctx=e["max_ctx"],
        prefill_bucket_min=e["prefill_bucket_min"],
        prefill_bucket_max=e["prefill_bucket_max"]), device=device)


def scheduler(eng: Engine, e: dict) -> Scheduler:
    return Scheduler(eng, SchedulerConfig(
        prefill_token_budget=e["prefill_token_budget"]))


def buckets(e: dict) -> list:
    """The prefill buckets a mix can use: powers of two from the smallest
    up to the largest chunk the budget allows."""
    top = min(e["prefill_bucket_max"], e["prefill_token_budget"])
    out, b = [], e["prefill_bucket_min"]
    while True:
        out.append(b)
        if b >= top:
            return out
        b *= 2


def warm_serving(eng: Engine, a: ArchConfig, e: dict, device) -> None:
    """One prefill dispatch at every bucket and one decode step of the
    served weights, on a cache of their own: every shape the window runs,
    with the engine's state untouched."""
    slots = e["batch_slots"]
    cache = init_cache(a, slots, e["max_ctx"], torch.float32, device)
    zero = torch.zeros(slots, dtype=torch.int64, device=device)
    for b in buckets(e):
        toks = torch.ones((slots, b), dtype=torch.int64, device=device)
        prefill_step(eng.params, toks, a, cache, zero,
                     torch.full((slots,), b, dtype=torch.int64,
                                device=device))
    decode_step(eng.params, torch.ones((slots, 1), dtype=torch.int64,
                                       device=device), a, cache, zero,
                active=torch.ones(slots, dtype=torch.bool, device=device))


def optimizer_config(opt: dict) -> OptimizerConfig:
    return OptimizerConfig(**opt)


def train_step(a: ArchConfig, opt: dict):
    return make_train_step(a, TrainConfig(opt=optimizer_config(opt)))
