"""Everything of a cell is found by name: its entry in ``BENCHMARK.json``,
``configs/<config>.json`` (which names its plain reference,
``reference/<reference>.py``), ``traffic/<traffic>.json`` (which names its
driver, ``harness/drivers/<driver>.py``), ``limits/<workload>.json`` (the
limits of its correctness check) and ``metrics/<metric>.py`` (one reader
a per-layer metric). Adding a configuration, a model family, a mix, a
driver kind, a cell or a metric adds files and entries; no code here
names one."""
from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]      # perfbench/
ROOT = HERE.parent                              # the checkout


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read: ``config``,
    ``mix``, ``limits`` (empty where the cell has none: it cannot come out
    correct) and the metrics it reports."""

    def __init__(self, workload: str, bench: dict = None, here: Path = HERE):
        bench = bench if bench is not None else json.loads(
            (here.parent / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = json.loads(
            (here / "configs" / f"{self.entry['config']}.json").read_text())
        self.mix = json.loads(
            (here / "traffic" / f"{self.entry['traffic']}.json").read_text())
        lim = here / "limits" / f"{workload}.json"
        self.limits = json.loads(lim.read_text()) if lim.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]
        self.here = here


def reference_module(config: dict):
    """The plain reference named by the configuration: its ``Model`` and
    the counts of its work (``projections``, ``token_flops``)."""
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def reference_model(config: dict, precision: str = "f32"):
    return reference_module(config).Model(config, precision)


def _load(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    return _load(here / "metrics" / f"{name}.py", "perfbench_metric_").read


def driver(cell):
    """``harness/drivers/<driver>.py`` of the cell's mix."""
    return _load(cell.here / "harness" / "drivers" /
                 f"{cell.mix['driver']}.py", "perfbench_driver_")


def pin_host() -> None:
    """Keep the process on one core (the last it may use), so that the
    host's one thread of work is not moved between cores mid-run."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
