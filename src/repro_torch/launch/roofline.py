"""Roofline terms of one dry-run cell, counted over a ``meta`` trace of the
rank-local SPMD program; the port's counterpart of
``repro.launch.roofline``, in H100 terms (``launch.mesh.HW``):

    compute term    = flops per device / HW.PEAK_FLOPS_BF16
    memory term     = bytes per device / HW.HBM_BW
    collective term = collective bytes per device / HW.NVLINK_BW

The collective term is a lower bound: it prices every collective at one
GPU's NVLink rate, and a 16-wide "model" axis spans two 8-GPU nodes,
whose links between nodes are slower.

One ``TorchDispatchMode`` (``TraceCounter``) replaces the reference's
``cost_analysis()`` and HLO parse. It sees the aten ops of rank 0's
program on plain ``meta`` tensors (a DTensor op returns ``NotImplemented``
to it, so DTensor runs and the mode sees the local ops and collectives it
issues):

  flops       ``torch.utils.flop_counter``'s formulas for the digital
              matmuls, batched matmuls and attention; plus 2·M·K·N for
              every CIM projection, which ``cim_matmul``'s ``meta``
              short-circuit answers without a matmul the counter could
              see: it tells the counter of each such call
              (``kernels.ops.META_WATCHERS``). The MoE experts do not go
              through it: their digital batched matmuls run on ``meta``
              and are counted as ops;
  bytes       every aten op's input and output bytes, views and
              allocations without data excluded, and each CIM
              projection's x, weight and output bytes (the short-circuit
              again): an unfused upper bound, like HLO's "bytes
              accessed"; collectives are left out;
  collectives the output bytes of every ``c10d`` and ``_c10d_functional``
              collective, all-reduce weighted 2x (reduce-scatter +
              all-gather), the others 1x, by kind in the reference's
              names;
  memory      live storage bytes over the trace, each storage counted
              once (views share one; a tensor autograd saves stays live
              until its backward frees it): arguments, outputs, temps
              (the peak less the arguments and the new outputs), aliased
              (outputs that are arguments' storage, a cache written in
              place) and ``peak_est`` as ``launch.dryrun`` reports them.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import ops
from repro_torch.launch.mesh import HW

__all__ = ["RooflineReport", "TraceCounter", "model_flops_estimate",
           "roofline_from_trace", "COLLECTIVES"]

# ring all-reduce ~ reduce-scatter + all-gather
_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0, "broadcast": 1.0}

# op name -> kind; the output bytes are counted
COLLECTIVES = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.allgather_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "broadcast",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "broadcast",
    "_c10d_functional.broadcast_": "broadcast",
}
# ops that move no data: allocations, aliasing and the functional
# collectives' bookkeeping
_NO_BYTES = {"aten.empty", "aten.empty_like", "aten.new_empty",
             "aten.empty_strided", "aten.new_empty_strided", "aten.detach",
             "aten.alias", "aten.lift_fresh", "aten._local_scalar_dense",
             "_c10d_functional.wait_tensor",
             "_c10d_functional._wrap_tensor_autograd"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (the rank's shard), else ``t``."""
    return getattr(t, "_local_tensor", t)


class TraceCounter(TorchDispatchMode):
    """Flops, bytes, collective bytes by kind and live storage over the
    ops of a trace (module docstring). ``watch(args)`` registers the
    arguments' storages before the traced call."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.flops = 0            # the ops' flops, CIM projections apart
        self.cim_flops = 0
        self.bytes = 0            # every op's, CIM projections included
        self.cim_bytes = 0
        self.collectives: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self.arg_storages: Dict[int, int] = {}

    # ------------------------------------------------------------- memory
    def _track(self, t: torch.Tensor) -> int:
        st = _local(t).untyped_storage()
        key = id(st)
        if key not in self._storages:
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def watch(self, args) -> None:
        for t in _tensors(args):
            key = self._track(t)
            self.arg_storages[key] = self._storages[key]
        self.peak = max(self.peak, self.live)

    def memory(self, outputs) -> dict:
        """The reference's ``memory_analysis`` keys for ``outputs``."""
        args = sum(self.arg_storages.values())
        seen, new, aliased = set(), 0, 0
        for t in _tensors(outputs):
            key = id(_local(t).untyped_storage())
            if key in seen:
                continue
            seen.add(key)
            n = _local(t).untyped_storage().nbytes()
            if key in self.arg_storages:
                aliased += n
            else:
                new += n
        temps = max(0, self.peak - args - new)
        return {"arguments": args, "outputs": new + aliased, "temps": temps,
                "aliased": aliased,
                "peak_est": args + new + aliased + temps - aliased}

    # ------------------------------------------------- CIM projections
    def _cim(self, x, w, n: int) -> None:
        """One ``cim_matmul`` the ``meta`` short-circuit answered: 2·M·K·N
        flops, and x, the weight (a packed one's codes, scale and table)
        and the (M, N) output in x's dtype read or written once."""
        k = x.shape[-1]
        m = x.numel() // max(k, 1)
        self.cim_flops += 2 * m * k * n
        wts = [w] if torch.is_tensor(w) else [
            v for v in vars(w).values() if torch.is_tensor(v)]
        moved = (m * k + m * n) * x.element_size() \
            + sum(_nbytes(t) for t in wts)
        self.cim_bytes += moved
        self.bytes += moved

    def __enter__(self):
        ops.META_WATCHERS.append(self._cim)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.META_WATCHERS.remove(self._cim)
        return super().__exit__(*exc)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket._qualified_op_name.replace("::", ".")
        kind = COLLECTIVES.get(name)
        if kind is not None:
            # the in-place c10d ops take their outputs first
            moved = _tensors(args[0] if name.startswith("c10d.") else out)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + (
                _WEIGHT[kind] * sum(_nbytes(t) for t in moved))
        else:
            packet = func._overloadpacket
            if packet in self._flops_of:
                self.flops += int(self._flops_of[packet](
                    *args, **kwargs, out_val=out))
            if name not in _NO_BYTES and not func.is_view:
                self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                    + sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    model_flops: float           # 6·N_active·D (global)
    peak_util_bound: float       # model_flops share of compute-term time

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def hlo_per_model_flops(self) -> float:
        global_hlo = self.flops_per_device * self.chips
        return global_hlo / self.model_flops if self.model_flops else math.nan

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the cell can reach: useful-FLOP
        time over the max of all three terms."""
        t_useful = (self.model_flops / self.chips) / HW.PEAK_FLOPS_BF16
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / bound if bound else math.nan

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo/model": self.hlo_per_model_flops,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg, case) -> float:
    """6·N_active·D for training, 2·N_active·D per generated/scored token
    otherwise (N = active params, D = tokens processed)."""
    n_active = _active_params(cfg)
    if case.kind == "train":
        tokens = case.global_batch * case.seq_len
        return 6.0 * n_active * tokens
    if case.kind == "prefill":
        tokens = case.global_batch * case.seq_len
        return 2.0 * n_active * tokens
    tokens = case.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def _active_params(cfg) -> float:
    """Parameters touched per token (MoE: top-k experts only; embeddings
    excluded, LM head included)."""
    total = cfg.param_count()
    if cfg.input_mode == "tokens":
        total -= cfg.vocab_size * cfg.d_model  # embedding lookup isn't a matmul
    if cfg.is_moe:
        e_ff = cfg.expert_d_ff
        nmat = 3 if cfg.gated_mlp else 2
        per_layer = nmat * cfg.d_model * e_ff
        n_moe_layers = sum(1 for k in cfg.blocks() if k != "ssm")
        total -= (cfg.n_experts - cfg.top_k) * per_layer * n_moe_layers
    return float(total)


def roofline_from_trace(arch_name: str, shape_name: str, mesh_name: str,
                        chips: int, fn, args, cfg, case):
    """Run ``fn(*args)`` (a ``meta`` trace) under ``TraceCounter``.
    Returns (the report, the memory dict, the cost dict)."""
    counter = TraceCounter()
    counter.watch(args)
    with counter:
        out = fn(*args)
    memory = counter.memory(out)
    del out
    flops = float(counter.flops + counter.cim_flops)
    byts = float(counter.bytes)
    coll = dict(sorted(counter.collectives.items()))
    coll_total = sum(coll.values())
    mf = model_flops_estimate(cfg, case)
    rep = RooflineReport(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=coll_total, coll_breakdown=coll,
        t_compute=flops / HW.PEAK_FLOPS_BF16,
        t_memory=byts / HW.HBM_BW,
        t_collective=coll_total / HW.NVLINK_BW,
        model_flops=mf,
        peak_util_bound=(mf / chips / HW.PEAK_FLOPS_BF16))
    cost = {"flops_per_device": flops,
            "cim_flops_per_device": float(counter.cim_flops),
            "digital_flops_per_device": float(counter.flops),
            "bytes_per_device": byts,
            "cim_bytes_per_device": float(counter.cim_bytes),
            "collective_bytes_per_device": coll_total,
            "collective_breakdown": coll}
    return rep, memory, cost
