"""Multi-pod dry run: trace every (architecture x input shape) cell's
rank-local SPMD program on the production meshes, on ``meta`` tensors
under torch's ``fake`` process group (256 ranks for one pod, 512 for
two; rank 0's program), and report per-device memory, flops, collective
bytes and the roofline terms in H100 terms (``launch.roofline``). No data
moves and nothing is compiled: the port's counterpart of
``repro.launch.dryrun``, whose per-cell JSON keys it keeps (``trace_s``
for ``lower_s`` / ``compile_s``), plus ``fits`` (``peak_est`` within
``HW.HBM_BYTES``). The figures are data-sheet model outputs, not
measurements.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--cim grmac]

The JSON goes to ``--out`` (default ``build/dryrun``, outside the
committed records).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.roofline import roofline_from_trace
from repro_torch.launch.specs import SHAPES, cell_is_runnable, make_cell

__all__ = ["ARCHS", "DEFAULT_OUT", "fake_world", "run_cell", "main"]

ARCHS = [
    "arctic-480b", "grok-1-314b", "qwen2-1.5b", "gemma3-1b", "granite-8b",
    "stablelm-3b", "mamba2-1.3b", "recurrentgemma-9b", "musicgen-medium",
    "chameleon-34b",
]
DEFAULT_OUT = "build/dryrun"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks (``FakeStore``; this
    process is rank 0) for the block, ended on exit. A group already up
    is used when it is a fake one of at least ``n`` ranks."""
    # DTensor warns wherever it reduces a partial sum over several mesh
    # dimensions one after another (the multi-pod mesh's reductions),
    # which a dry run does by design
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with _world(n):
            yield
    finally:
        log.setLevel(level)


@contextlib.contextmanager
def _world(n: int):
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < n:
            raise RuntimeError(
                f"a dry run needs a fake process group of {n} ranks; a "
                f"{dist.get_backend()} group of {dist.get_world_size()} is up")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, multi_pod: bool, cim: str = "off",
             out_dir: str = DEFAULT_OUT, verbose: bool = True,
             roofline_mode: bool = False, overrides: dict | None = None,
             tag_suffix: str = "", microbatches: int = 1,
             grad_compression: bool = False, cache_dtype: str = "bfloat16",
             algorithm: str = "adamw", layout: str = "fsdp",
             model_parallel: int = 16):
    """One dry-run cell on the production mesh. ``roofline_mode`` traces
    attention unchunked (``attn_chunk=None``); the port's layers are a
    Python loop, so every op is counted once either way."""
    dp = 256 // model_parallel
    mesh_name = (f"2x{dp}x{model_parallel}" if multi_pod
                 else f"{dp}x{model_parallel}")
    cfg = get_config(arch)
    if cim != "off":
        cfg = cfg.replace(cim=cfg.cim.with_mode(cim))
    if roofline_mode:
        cfg = cfg.replace(attn_chunk=None)
    if overrides:
        cfg = cfg.replace(**overrides)
    ok, reason = cell_is_runnable(cfg, shape)
    result = {"arch": arch, "shape": shape, "mesh": mesh_name, "cim": cim}
    os.makedirs(out_dir, exist_ok=True)
    tag = (f"{arch}_{shape}_{mesh_name}" + (f"_{cim}" if cim != "off" else "")
           + ("_roofline" if roofline_mode else "") + tag_suffix)
    path = os.path.join(out_dir, tag + ".json")
    if not ok:
        result.update(status="skipped", reason=reason)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        if verbose:
            print(f"[dryrun] {tag}: SKIPPED ({reason})")
        return result

    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        model_parallel=model_parallel)
            chips = mesh.size()
            cell = make_cell(cfg, shape, mesh,
                             cache_dtype=_DTYPES[cache_dtype],
                             microbatches=microbatches,
                             grad_compression=grad_compression,
                             algorithm=algorithm, layout=layout)
            rep, mem, cost = roofline_from_trace(
                arch, shape, mesh_name, chips, cell.fn, cell.args, cfg,
                SHAPES[shape])
            del cell
        t_trace = time.time() - t0
        result.update(
            status="ok", trace_s=round(t_trace, 1), bytes_per_device=mem,
            fits=mem["peak_est"] <= HW.HBM_BYTES, cost=cost,
            roofline=rep.row())
        if verbose:
            gb = mem["peak_est"] / 2**30
            print(f"[dryrun] {tag}: OK trace={t_trace:.1f}s "
                  f"mem/dev={gb:.2f}GiB fits={result['fits']} "
                  f"dominant={rep.dominant} "
                  f"roofline_frac={rep.roofline_fraction:.3f}")
    except Exception as e:  # report, don't crash the sweep
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def sweep(archs, shapes, meshes, **kw) -> list:
    """``run_cell`` over every (mesh, arch, shape), one fake group a
    mesh size."""
    rows = []
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for a in archs:
                for s in shapes:
                    rows.append(run_cell(a, s, mp, **kw))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cim", default="off", choices=["off", "fakequant",
                                                     "grmac"])
    ap.add_argument("--roofline-mode", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    rows = sweep(archs, shapes, meshes, cim=args.cim, out_dir=args.out,
                 roofline_mode=args.roofline_mode)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
