"""What every driver hands back to ``run.py``: the result of one run and
the pieces of its line that do not depend on the driver."""
from __future__ import annotations

import gc
from dataclasses import dataclass, field

import torch

from perfbench.harness.spec import metric_reader


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    checks: dict
    extra: dict = field(default_factory=dict)


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def per_layer(cell, ctx) -> dict:
    """Each per-layer metric of the cell that its reader finds in ``ctx``."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], cell.here)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(cell, values: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics among ``values``, and ``setup_s``."""
    out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
           for m in cell.end_to_end if values.get(m["name"]) is not None}
    out["setup_s"] = {"value": setup_s, "unit": "s"}
    return out


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
