"""The harness on the CPU: traffic from the seed, the window's statistics,
the roofline arithmetic, the names in ``BENCHMARK.json``, and files found
by name."""
import json
import re
import shutil
import sys
import types
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import roofline, traffic  # noqa: E402
from perfbench.harness.drivers import closed_loop  # noqa: E402
from perfbench.harness.spec import (HERE, Cell, driver,  # noqa: E402
                                    metric_reader, reference_module)

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
MIXES = {w["traffic"] for w in BENCH["workloads"]}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


CHAT_MIXES = sorted(m for m in MIXES if _mix(m)["driver"] == "closed_loop")


@pytest.mark.parametrize("name", CHAT_MIXES)
def test_requests_follow_the_seed(name):
    mix = _mix(name)
    a = traffic.closed_loop_requests(mix, 50000, 2 ** 40 + 1)
    b = traffic.closed_loop_requests(mix, 50000, 2 ** 40 + 1)
    c = traffic.closed_loop_requests(mix, 50000, 7)
    assert a == b and a != c and len(a) == mix["requests"]
    k = mix["block"]
    for block in range(3):
        def sizes(reqs, key):
            return Counter(len(r["prompt"]) if key == "p" else r[key]
                           for r in reqs[block * k:(block + 1) * k])
        # every seed asks for the same work a block, in another order
        assert sizes(a, "p") == sizes(c, "p")
        assert sizes(a, "max_tokens") == sizes(c, "max_tokens")
    assert all(1 <= t < 50000 for r in a for t in r["prompt"])


@pytest.mark.parametrize("name", CHAT_MIXES)
def test_lengths_follow_the_cited_law_and_cuts(name):
    mix = _mix(name)
    reqs = traffic.closed_loop_requests(mix, 50000, 2 ** 35 + 3)
    p = np.array([len(r["prompt"]) for r in reqs])
    o = np.array([r["max_tokens"] for r in reqs])
    assert p.min() >= mix["min_len"] and o.min() >= mix["min_len"]
    assert p.max() <= mix["prompt_max"]
    assert (p + o).max() <= mix["total_max"] <= mix["engine"]["max_ctx"]
    # the published means, but for the cuts
    assert p.mean() == pytest.approx(mix["prompt_mean"], rel=0.03)
    assert o.mean() == pytest.approx(mix["output_mean"], rel=0.03)
    # a prompt's length says nothing of its output's: drawn in orders of
    # their own, one prompt length meets many output lengths
    assert abs(np.corrcoef(p, o)[0, 1]) < 0.1
    longest = p.max()
    assert len(set(o[p == longest].tolist())) > 10


def test_train_batches_follow_the_seed_and_differ_by_row():
    mix = _mix("lm-16x512")
    one = traffic.train_batch(mix, 32000, 2 ** 40, 3, "cpu")
    assert torch.equal(one["inputs"],
                       traffic.train_batch(mix, 32000, 2 ** 40, 3,
                                           "cpu")["inputs"])
    assert not torch.equal(one["inputs"], traffic.train_batch(
        mix, 32000, 2 ** 40, 4, "cpu")["inputs"])
    rows = {tuple(r.tolist()) for r in one["inputs"]}
    assert len(rows) == mix["batch"]
    assert torch.equal(one["labels"][:, :-1], one["inputs"][:, 1:])


def _run(step_s, n_steps, stall_at=None, stall=0.0, lanes=8):
    """A run of ``n_steps`` decode steps of ``lanes`` requests each; one
    step ``stall`` longer."""
    run = closed_loop.Run()
    run.t0 = 0.0
    t = 0.0
    for i in range(lanes):
        run.times[i] = []
    for k in range(n_steps):
        t += step_s + (stall if k == stall_at else 0.0)
        for i in range(lanes):
            run.times[i].append(t)
    run.t1 = t
    return run


def test_window_statistics_take_every_token_and_gap():
    calm = closed_loop.end_to_end(_run(0.02, 100))
    stalled = closed_loop.end_to_end(_run(0.02, 100, stall_at=50, stall=1.0))
    assert calm["tokens"] == stalled["tokens"] == 800
    assert calm["gen_tok_s"] == pytest.approx(800 / 2.0)
    assert stalled["gen_tok_s"] == pytest.approx(800 / 3.0)
    assert calm["itl_p95_ms"] == pytest.approx(20.0)
    # 8 of 792 gaps hold the stall: one in a hundred, inside the top 5%
    # but not the top 1%
    assert stalled["itl_p95_ms"] == pytest.approx(20.0)
    assert stalled["itl_p99_ms"] > 100.0
    assert calm["halves_tok_s"] == pytest.approx([400.0, 400.0], rel=0.03)
    many = _run(0.02, 100)
    for k in range(60, 100, 8):
        for i in range(8):
            many.times[i] = [s + (1.0 if j >= k else 0.0) for j, s in
                             enumerate(many.times[i])]
    many.t1 += 5.0
    assert closed_loop.end_to_end(many)["itl_p95_ms"] > 100.0


def _projections(config_name):
    cfg = json.loads((HERE / "configs" / f"{config_name}.json").read_text())
    return reference_module(cfg).projections(cfg["arch"])


def test_bound_of_the_paper_model_forwards():
    projs = _projections("paper-cim-120m")
    assert roofline.calls_per_forward(projs) == 85
    assert round(roofline.forward_bound_ms(projs, 32, 8), 4) == 0.0229
    assert round(roofline.forward_bound_ms(projs, 32, 2048), 4) == 1.3165
    assert roofline.matmul_params(projs) == (
        12 * (4 * 768 ** 2 + 3 * 768 * 3072) + 768 * 32000)
    assert roofline.calls_per_forward(_projections("mamba2-1.3b")) == 193


def test_benchmark_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w["config"] for w in BENCH["workloads"]] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    text = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + \
        [c["source"] for c in BENCH["configs"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in text)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m[
            "workloads"]))
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert (HERE.parent / c["file"]).exists()
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    here = tmp_path / "perfbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("tests"))
    cfg = json.loads((here / "configs" / "paper-cim-120m.json").read_text())
    cfg["arch"]["n_layers"] = 24
    cfg["reference"] = "toy_lm"
    (here / "configs" / "paper-deep.json").write_text(json.dumps(cfg))
    mix = dict(_mix("chat-sharegpt8"), clients=16, driver="open_loop")
    (here / "traffic" / "chat-open16.json").write_text(json.dumps(mix))
    (here / "harness" / "drivers" / "open_loop.py").write_text(
        "def measure(cell, args, program, t_start):\n"
        "    return cell.mix['clients']\n")
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    # a new model family: its reference module, found by the name the
    # configuration gives, counts its own projections
    toy = types.ModuleType("perfbench.reference.toy_lm")
    toy.projections = lambda arch: [(arch["d_model"], 7, arch["n_layers"])]
    monkeypatch.setitem(sys.modules, "perfbench.reference.toy_lm", toy)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "deep-chat", "config": "paper-deep",
                               "traffic": "chat-open16", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "gen_tok_s",
                               "workloads": ["deep-chat"]})
    cell = Cell("deep-chat", bench, here=here)
    assert cell.config["arch"]["n_layers"] == 24
    assert cell.mix["clients"] == 16
    assert [m["name"] for m in cell.per_layer] == ["steps_seen"]
    assert driver(cell).measure(cell, None, None, 0.0) == 16
    projs = reference_module(cell.config).projections(cell.config["arch"])
    assert roofline.calls_per_forward(projs) == 24

    class Ctx:
        steps = 7
    assert metric_reader("steps_seen", here)(Ctx) == 7.0


@pytest.mark.parametrize("kind", sorted(
    p.stem for p in (HERE / "harness" / "drivers").glob("*.py")
    if p.stem != "__init__"))
def test_every_driver_measures_and_calibrates(kind):
    cell = types.SimpleNamespace(here=HERE, mix={"driver": kind})
    mod = driver(cell)
    assert callable(mod.measure) and callable(mod.calibrate)
