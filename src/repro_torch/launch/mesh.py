"""Mesh construction on ``torch.distributed``; the port's counterpart of
``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes ("data", "model"). Multi-pod:
2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model"): "pod" carries
pure data parallelism across the slow inter-pod links, "data" is FSDP
within a pod, "model" is tensor / expert parallel. Both are built on the
process group that is up, over its first ranks: a real one on a cluster,
or the ``fake`` one (``FakeStore``, any world size, no data moved) for dry
runs and tests on the CPU. Functions, never module-level constants, so
importing this module touches no process group.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Optional, Union

import torch
import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "local_mesh",
           "make_mesh", "HW"]


class HW:
    """NVIDIA H100 SXM5 80GB data-sheet figures (dense) for the roofline
    model, at the card's 700 W board power limit (``CARD``); a card set
    below it runs slower under load."""

    CARD = "NVIDIA H100 80GB HBM3, 700 W"
    PEAK_FLOPS_BF16 = 989e12      # tensor cores, dense
    PEAK_FLOPS_F32 = 67e12        # CUDA cores
    HBM_BW = 3.35e12              # B/s
    NVLINK_BW = 450e9             # B/s each way (NVLink 4, 18 links)
    HBM_BYTES = 80 * 10**9
    SMEM_BYTES = 228 * 2**10      # shared memory per SM


def make_mesh(shape, axes, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the process group that is up."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("no process group is up: init_process_group "
                           "first (the 'fake' backend for a dry run)")
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         model_parallel: int = 16):
    """The production mesh over 256 (single pod) or 512 (2 pods) ranks.
    ``model_parallel`` re-maps the logical split over the same hardware:
    (256 / mp, mp), or (2, 256 / mp, mp)."""
    chips_per_pod = 256
    dp = chips_per_pod // model_parallel
    shape = (2, dp, model_parallel) if multi_pod else (dp, model_parallel)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(device: Optional[Union[str, torch.device]] = None):
    """A (world, 1) ("data", "model") mesh over the process group that is
    up, 1 x 1 on one process: see ``local_mesh``, which also starts the
    group."""
    device = torch.device(device) if device is not None else None
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n, 1), ("data", "model"),
                     None if device is None else device.type)


@contextlib.contextmanager
def local_mesh(device: Optional[Union[str, torch.device]] = None):
    """``make_local_mesh`` on this process's one device: the card (None)
    on a world-1 NCCL group, or the CPU on a world-1 gloo group when
    asked, each started here with a ``file://`` store under the temporary
    directory, and ended on exit. A process group already up is used as it
    is and left up."""
    from repro_torch.core.device import resolve_device

    device = resolve_device(device)
    owned = not dist.is_initialized()
    if owned:
        backend = "nccl" if device.type == "cuda" else "gloo"
        fd, store = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.remove(store)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1)
    try:
        yield make_local_mesh(device)
    finally:
        if owned:
            dist.destroy_process_group()
