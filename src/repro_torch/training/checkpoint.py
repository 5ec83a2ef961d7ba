"""Fault-tolerant checkpoints: atomic, content-verified, two-tier, async;
the port's counterpart of ``repro.training.checkpoint``, in the same
layout (one directory per step):

    <dir>/step_000000123.tmp0/...  (written first)
    <dir>/step_000000123/          (published by one atomic rename)
        meta.json                  step, leaf manifest with sha256
        arr_00000.npy ...          one file per leaf of the tree

A tree is a nested dict / list of tensors (``repro_torch.tree``; a DTensor
leaf is saved as its full value, and restored onto the template's device
as a plain tensor, for ``fault.reshard_tree`` to place); a leaf's
path (``params/layers/0/attn/wq/w``) keys the manifest. numpy has no
bfloat16, so a bf16 leaf is stored as its 16-bit pattern (uint16) and its
manifest entry says "bfloat16". Restore picks the newest *complete* step
whose leaves verify, skipping a corrupt one with a UserWarning; an
explicit step fails loudly; a shape mismatch always raises. ``keep``
bounds the steps kept.

``AsyncCheckpointer`` writes two tiers from a background thread: a
*local* tier (fast, every ``local_every`` steps, short retention) and a
*durable* one (every ``durable_every``). The training thread only copies
the tree to the host (``snapshot_tree``; its seconds go to
``stats["stall_s"]``); a failed write publishes nothing and is collected
in ``errors``. ``restore`` walks the tiers freshest step first (local wins
ties).
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.sharding import is_dtensor
from repro_torch.tree import tree_map_with_path, tree_paths

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "snapshot_tree", "write_snapshot", "AsyncCheckpointer"]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy (a DTensor's full value), and its
    torch dtype's name."""
    name = str(t.dtype).replace("torch.", "")
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(a: np.ndarray, dtype: str, like: torch.Tensor
                ) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device)


def snapshot_tree(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    """Host copies of every leaf, ``(path, array, dtype name)``: the part of
    a save that runs on the training thread; later steps cannot change
    it, so a background thread may write it."""
    return [(path, *_to_numpy(leaf)) for path, leaf in tree_paths(tree)]


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_snapshot(directory: str, step: int,
                   snapshot: List[Tuple[str, np.ndarray, str]],
                   keep: int = 3) -> str:
    """Write a host snapshot: a tmp directory with the leaf files and the
    sha256 manifest, ``meta.json`` last, then one atomic rename publishes
    the step; older steps beyond ``keep`` are removed."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp0")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for i, (path, arr, dtype) in enumerate(snapshot):
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
        manifest[path] = {"file": fn, "sha256": _sha256(os.path.join(tmp, fn)),
                          "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    for s in sorted(_complete_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Blocking save: snapshot on the caller, write, publish."""
    return write_snapshot(directory, step, snapshot_tree(tree), keep)


def _complete_steps(directory: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and ".tmp" not in d
            and os.path.exists(os.path.join(directory, d, "meta.json"))]


def _verify_step(directory: str, step: int) -> None:
    """Raise if a leaf file of the published step is missing or fails its
    hash."""
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    for key, ent in meta["leaves"].items():
        fp = os.path.join(d, ent["file"])
        if _sha256(fp) != ent["sha256"]:
            raise IOError(f"checkpoint corruption at {key} ({fp})")


def latest_step(directory: str, *, verify: bool = False) -> Optional[int]:
    """Newest complete step, or None; with ``verify`` the newest whose
    leaves verify, warning (UserWarning) for each corrupt step skipped."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(_complete_steps(directory), reverse=True)
    if not verify:
        return steps[0] if steps else None
    for s in steps:
        try:
            _verify_step(directory, s)
            return s
        except (OSError, KeyError, json.JSONDecodeError) as e:
            warnings.warn(
                f"skipping corrupt checkpoint step {s} under {directory}: "
                f"{e}", UserWarning, stacklevel=2)
    return None


def _restore_step(directory: str, template: Any, step: int,
                  verify: bool) -> Tuple[Any, int]:
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)

    def load(key, tmpl):
        ent = meta["leaves"][key]          # KeyError: a leaf is missing
        fp = os.path.join(d, ent["file"])
        if verify and _sha256(fp) != ent["sha256"]:
            raise IOError(f"checkpoint corruption at {key} ({fp})")
        arr = np.load(fp, allow_pickle=False)
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs template {tuple(tmpl.shape)}")
        return _from_numpy(arr, ent["dtype"], tmpl)

    return tree_map_with_path(load, template), meta["step"]


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None,
                       verify: bool = True) -> Tuple[Any, int]:
    """Restore into the structure (and devices) of ``template``.

    With ``step=None`` steps are tried newest first: one that fails hash or
    leaf verification is skipped with a UserWarning. An explicit ``step``
    must load. Shape mismatches always propagate."""
    if step is not None:
        return _restore_step(directory, template, step, verify)
    steps = (sorted(_complete_steps(directory), reverse=True)
             if os.path.isdir(directory) else [])
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    errors = []
    for s in steps:
        try:
            return _restore_step(directory, template, s, verify)
        except ValueError:
            raise
        except (OSError, KeyError, json.JSONDecodeError) as e:
            errors.append((s, e))
            warnings.warn(
                f"checkpoint step {s} under {directory} failed "
                f"verification ({e}); falling back to the next-newest "
                "complete step", UserWarning, stacklevel=2)
    raise IOError(f"every checkpoint under {directory} failed verification: "
                  + "; ".join(f"step {s}: {e}" for s, e in errors))


# ------------------------------------------------------------- async tiers
class AsyncCheckpointer:
    """Two-tier asynchronous checkpoint writer (see the module docstring).
    ``stats`` counts the saves scheduled per tier and sums ``stall_s``,
    the training thread's seconds in snapshot and enqueue."""

    TIERS = ("local", "durable")   # restore preference on equal steps

    def __init__(self, durable_dir: str, local_dir: Optional[str] = None, *,
                 durable_every: int = 50, local_every: int = 10,
                 keep_durable: int = 3, keep_local: int = 2):
        self.dirs = {"durable": durable_dir}
        if local_dir is not None:
            self.dirs["local"] = local_dir
        self.every = {"durable": durable_every, "local": local_every}
        self.keep = {"durable": keep_durable, "local": keep_local}
        self.stats = {"local": 0, "durable": 0, "stall_s": 0.0}
        self.errors: List[Exception] = []
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, name="ckpt-writer",
                                        daemon=True)
        self._worker.start()
        self._closed = False

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                write_snapshot(*item)
            except Exception as e:  # noqa: BLE001 — surfaced via .errors
                self.errors.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any, tiers=("durable",)) -> list:
        """Snapshot once on the calling thread, enqueue one write per
        tier; returns the tiers scheduled."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        tiers = [t for t in tiers if t in self.dirs]
        if not tiers:
            return []
        t0 = time.perf_counter()
        snap = snapshot_tree(tree)
        for tier in tiers:
            self._q.put((self.dirs[tier], step, snap, self.keep[tier]))
            self.stats[tier] += 1
        self.stats["stall_s"] += time.perf_counter() - t0
        return tiers

    def maybe_save(self, step: int, tree: Any) -> list:
        """Local every ``local_every`` steps, durable every
        ``durable_every`` (a step due in both snapshots once)."""
        due = [t for t in ("local", "durable")
               if t in self.dirs and step % self.every[t] == 0]
        return self.save(step, tree, due) if due else []

    def drain(self) -> None:
        """Wait for every enqueued write; warn about failed ones."""
        self._q.join()
        if self.errors:
            warnings.warn(
                f"{len(self.errors)} checkpoint write(s) failed (first: "
                f"{self.errors[0]!r}); those steps were never published "
                "and restore falls back", UserWarning, stacklevel=2)

    def close(self) -> None:
        if not self._closed:
            self.drain()
            self._closed = True
            self._q.put(None)
            self._worker.join()

    def invalidate_local(self) -> None:
        """Drop the local tier (a lost node takes its local disk along)."""
        d = self.dirs.get("local")
        if d and os.path.isdir(d):
            shutil.rmtree(d)
            os.makedirs(d, exist_ok=True)

    def freshest(self, *, include_local: bool = True) -> list:
        """(tier, step) candidates, freshest first, local winning ties."""
        out = []
        for tier in self.TIERS:
            d = self.dirs.get(tier)
            if d is None or (tier == "local" and not include_local):
                continue
            s = latest_step(d)
            if s is not None:
                out.append((tier, s))
        return sorted(out, key=lambda ts: (-ts[1], self.TIERS.index(ts[0])))

    def restore(self, template: Any, *,
                include_local: bool = True) -> Tuple[Any, int, str]:
        """The freshest valid checkpoint across tiers: (state, step,
        tier)."""
        self.drain()
        errors = []
        for tier, _ in self.freshest(include_local=include_local):
            try:
                state, step = restore_checkpoint(self.dirs[tier], template)
                return state, step, tier
            except (OSError, KeyError, json.JSONDecodeError) as e:
                errors.append((tier, e))
                warnings.warn(f"checkpoint tier '{tier}' unusable ({e}); "
                              "falling back to the next tier", UserWarning,
                              stacklevel=2)
        raise FileNotFoundError("no restorable checkpoint in any tier"
                                + (f" ({errors})" if errors else ""))
