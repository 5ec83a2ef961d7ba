"""Cells of the benchmark cut to CPU-test size: the cell's own
configuration file with every size shrunk, its own mix with fewer lanes
and shorter requests, its limits and the metric readers, written into a
directory laid out as ``perfbench/`` is. ``mamba2-chat``, the mamba2-1.3b
configuration under the chat mix, is not a cell of ``BENCHMARK.json``
yet; its reference is held to the port here all the same."""
import json
import shutil
from pathlib import Path

from perfbench.harness.spec import HERE, Cell

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SIZES = {
    "paper-cim-120m": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                           d_head=32, d_ff=256, vocab_size=512),
    "mamba2-1.3b": dict(n_layers=2, d_model=128, ssm_state=16,
                        ssm_headdim=32, vocab_size=500),
}
SERVE = dict(clients=4, prompt_mean=12.0, output_mean=4.0, min_len=2,
             prompt_max=40, total_max=64, block=16, requests=64,
             trace_lead_s=0.5, trace_seconds=1.0,
             engine={"batch_slots": 4, "max_ctx": 64,
                     "prefill_bucket_min": 8, "prefill_bucket_max": 16,
                     "prefill_token_budget": 16})
TRAIN = dict(batch=4, seq_len=32, trace_lead_s=0.2, trace_seconds=0.5)


# the limit mamba2-chat's fp8 control was held to on the card
LATER = {"mamba2-chat": ({"name": "mamba2-chat", "config": "mamba2-1.3b",
                          "traffic": "chat-sharegpt8", "chips": 1,
                          "why": "CPU tests only"},
                         {"served_gap": 0.5, "min_tokens": 20})}


def cell(tmp: Path, workload: str) -> Cell:
    """The workload at CPU size under ``tmp``."""
    bench = json.loads(json.dumps(BENCH))
    if workload in LATER:
        bench["workloads"].append(LATER[workload][0])
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir(parents=True, exist_ok=True)
    if not (tmp / "metrics").exists():
        shutil.copytree(HERE / "metrics", tmp / "metrics")
    cfg = json.loads((HERE / "configs" / f"{entry['config']}.json")
                     .read_text())
    cfg["arch"].update(SIZES[entry["config"]])
    mix = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    mix.update(TRAIN if mix["driver"] == "train" else SERVE)
    (tmp / "configs" / f"{entry['config']}.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / f"{entry['traffic']}.json").write_text(json.dumps(mix))
    lim = HERE / "limits" / f"{workload}.json"
    limits = (dict(LATER[workload][1]) if workload in LATER
              else json.loads(lim.read_text()))
    if "min_tokens" in limits:
        # a CPU-size window serves a few dozen tokens
        limits["min_tokens"] = 20
    (tmp / "limits" / lim.name).write_text(json.dumps(limits))
    if not (tmp / "harness").exists():
        shutil.copytree(HERE / "harness", tmp / "harness",
                        ignore=shutil.ignore_patterns("__pycache__"))
    return Cell(workload, bench, here=tmp)
