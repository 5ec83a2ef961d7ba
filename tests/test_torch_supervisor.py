"""The port's supervised fault drill (``training.supervisor``) and its
launchers (``launch.train``, ``launch.serve``) against the JAX package's.

* The GoodPut ledger partitions the wall clock (the reference's own
  scenarios).
* The drill of ``tests/test_supervisor.py`` (qwen2-1.5b reduced to 2
  layers, batch 2 x 16, the same two fault plans) runs in both packages
  from the reference's weights (``params_from_jax``) on the reference's
  batches; the port's on a world-1 gloo mesh on the CPU, its state
  DTensors after every restore. Every counter is equal (faults injected
  and detected, per kind, attempts, steps recomputed, checkpoints and
  restores per tier, remesh events, dp widths, final step); the losses
  agree within ``tests/test_torch_train_model.py``'s LOSS_RTOL 2e-6 and
  are bitwise equal to the port's own uninterrupted run; the GoodPut
  buckets sum to the wall time. The optimizer runs at AdamW eps = 1 and
  weight decay 0, as ``test_torch_train_model.py``'s step parity does: at
  eps = 1e-8 the first step is lr * sign(g), which an ulp of a near-zero
  gradient entry flips, and the reference decays its stacked per-layer
  vectors as matrices (ROADMAP section C).
* The drill ``chip_smoke.py`` runs on the card (``make_fault_plan(0,
  12)``, the default ``DrillConfig``) gives counters equal to the
  reference's and to ``chip_smoke.DRILL_COUNTERS`` (they are pure
  functions of plan and config, so a small model stands in).
* ``price_drill`` agrees with the reference's: the token counts exactly,
  pJ/token within ``chip_smoke.MC_TOL``'s fJ/Op share (both solved at
  2**11 columns, the regime MC_TOL was measured in).
* Both launchers run on the CPU at reduced width (``--device cpu``) and
  print the reference's lines: the demo's token lines equal (the
  reference's weights, the CIM path off), the others equal with their
  timings masked; the drill's JSON has the reference's keys and counters.
"""
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import fault as jfault  # noqa: E402
from repro.training import supervisor as jsup  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JOpt  # noqa: E402
from repro.training.trainer import TrainConfig as JTrain  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.training import fault as tfault  # noqa: E402
from repro_torch.training import supervisor as tsup  # noqa: E402
from repro_torch.training.optimizer import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.training.trainer import TrainConfig as TTrain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-6          # tests/test_torch_train_model.py
COUNTERS = ("final_step", "attempts", "faults_injected", "faults_detected",
            "fault_kill", "fault_device_loss", "fault_straggler",
            "steps_recomputed", "ckpt_local", "ckpt_durable",
            "restore_local", "restore_durable", "remesh_events",
            "dp_width_initial", "dp_width_final")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()


# ------------------------------------------------------------- ledger
def test_ledger_partitions_wall_clock():
    t = {"now": 0.0}
    led = tsup.GoodPutLedger(clock=lambda: t["now"]).start()
    t["now"] = 3.0
    led.to("productive")
    t["now"] = 10.0
    with led.in_bucket("checkpoint_stall"):
        t["now"] = 11.0
    t["now"] = 15.0
    wall = led.close()
    assert wall == 15.0
    assert led.buckets == {"productive": 11.0, "recompute": 0.0,
                           "checkpoint_stall": 1.0, "detection": 0.0,
                           "recovery": 0.0, "overhead": 3.0}
    assert led.report()["goodput_pct"] == pytest.approx(100 * 11 / 15)
    assert tsup.GoodPutLedger.BUCKETS == jsup.GoodPutLedger.BUCKETS


def test_ledger_rejects_misuse():
    led = tsup.GoodPutLedger()
    with pytest.raises(RuntimeError):
        led.to("productive")
    with pytest.raises(KeyError):
        led.start().to("nope")


# -------------------------------------------------------------- drills
class _JaxBatches:
    """The reference pipeline's batches as torch tensors."""

    def __init__(self, pipe):
        self.pipe = pipe

    def batch_at(self, step):
        return {k: torch.tensor(np.asarray(v))
                for k, v in self.pipe.batch_at(step).items()}


_SETUP = {}


def _setup(steps=6):
    if steps not in _SETUP:
        jarch = jax_get_config("qwen2-1.5b").reduced().replace(n_layers=2)
        tarch = torch_get_config("qwen2-1.5b").reduced().replace(n_layers=2)
        pipe = JaxSyntheticLM(JaxDataConfig(global_batch=2, seq_len=16,
                                            vocab_size=jarch.vocab_size,
                                            seed=3))
        opt = dict(lr=1e-3, warmup_steps=1, total_steps=steps, eps=1.0,
                   weight_decay=0.0)
        jp = jax.tree.map(np.asarray,
                          jax_init_params(jax.random.PRNGKey(0), jarch))
        _SETUP[steps] = (jarch, tarch, pipe, JTrain(steps=steps,
                                                    opt=JOpt(**opt)),
                         TTrain(steps=steps, opt=TOpt(**opt)), jp)
    return _SETUP[steps]


def _drills(tmp_path, plan_events, steps=6, **dkw):
    """(reference report, port report) of one plan."""
    jarch, tarch, pipe, jt, tt, jp = _setup(steps)
    kw = dict(steps=steps, **dkw)
    jplan = jfault.FaultPlan(tuple(jfault.FaultEvent(*e)
                                   for e in plan_events))
    tplan = tfault.FaultPlan(tuple(tfault.FaultEvent(*e)
                                   for e in plan_events))
    ref = jsup.Supervisor(jarch, jt, jsup.DrillConfig(
        workdir=str(tmp_path / "jax"), **kw), pipe, jplan,
        seed=0).run_drill()
    got = tsup.Supervisor(tarch, tt, tsup.DrillConfig(
        workdir=str(tmp_path / "torch"), **kw), _JaxBatches(pipe), tplan,
        params=params_from_jax(jp, tarch, "cpu"), device="cpu").run_drill()
    return ref, got


def _check(ref, got):
    assert {k: got[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    g = got["goodput"]
    assert sum(g["buckets_s"].values()) == pytest.approx(g["wall_s"])
    assert set(g["buckets_s"]) == set(ref["goodput"]["buckets_s"])
    assert g["counters"] == ref["goodput"]["counters"]


PLAN = ((1, "straggler", 4), (2, "kill"), (4, "device_loss"))


def test_drill_matches_reference_and_resumes_bitwise(tmp_path):
    ref, got = _drills(tmp_path / "a", PLAN, local_every=1,
                       durable_every=3, n_hosts=4, n_chips=8)
    _check(ref, got)
    assert got["faults_injected"] == got["faults_detected"] == 3
    assert got["restore_local"] == got["restore_durable"] == 1
    assert got["dp_width_final"] < got["dp_width_initial"]
    _, base = _drills(tmp_path / "b", (), local_every=1, durable_every=3,
                      n_hosts=4, n_chips=8)
    assert base["steps_recomputed"] == 0 and base["attempts"] == 1
    # the recomputed trajectory is bitwise the uninterrupted run's
    assert got["losses"] == base["losses"]
    assert 0 < got["goodput"]["goodput_pct"] < 100


def test_drill_survives_fault_before_first_cadence_save(tmp_path):
    ref, got = _drills(tmp_path, ((1, "kill"),), steps=3, local_every=10,
                       durable_every=10, n_hosts=4, n_chips=8)
    _check(ref, got)
    assert got["restore_durable"] == 1 and got["steps_recomputed"] == 1


def test_drill_restores_dtensors(tmp_path):
    """After a restore the state is DTensors on the 1 x 1 mesh, and the
    checkpoint round trip is exact."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import local_mesh
    from repro_torch.parallel import sharding
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.tree import tree_leaves

    _, tarch, _, _, tt, jp = _setup()
    params = params_from_jax(jp, tarch, "cpu")
    with local_mesh("cpu") as mesh:
        specs = sharding.param_specs(params, mesh)
        placed = tfault.reshard_tree(params, mesh, specs)
        assert all(isinstance(t, DTensor) for t in tree_leaves(placed))
        ckpt.save_checkpoint(str(tmp_path), 1, placed)
        back, step = ckpt.restore_checkpoint(str(tmp_path), placed)
        assert step == 1
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)


def test_chip_drill_counters(tmp_path):
    """The card's drill (``make_fault_plan(0, 12)``, default config) has
    the reference's counters, which ``chip_smoke.py`` holds."""
    jarch, tarch, pipe, jt, tt, jp = _setup(12)
    jplan = jfault.make_fault_plan(0, 12, n_faults=3)
    tplan = tfault.make_fault_plan(0, 12, n_faults=3)
    ref = jsup.Supervisor(jarch, jt, jsup.DrillConfig(
        workdir=str(tmp_path / "jax"), steps=12), pipe, jplan,
        seed=0).run_drill()
    got = tsup.Supervisor(tarch, tt, tsup.DrillConfig(
        workdir=str(tmp_path / "torch"), steps=12), _JaxBatches(pipe),
        tplan, params=params_from_jax(jp, tarch, "cpu"),
        device="cpu").run_drill()
    _check(ref, got)
    assert {k: ref[k] for k in COUNTERS} == CHIP.DRILL_COUNTERS
    assert [(e.step, e.kind) for e in tplan.events] == CHIP.DRILL_PLAN


def test_price_drill_matches_reference():
    jarch, tarch, *_ = _setup()
    rep = {"final_step": 12, "steps_recomputed": 4}
    n_cols = 1 << 11
    ref = jsup.price_drill(jarch, rep, tokens_per_step=1024, n_cols=n_cols)
    got = tsup.price_drill(tarch, rep, tokens_per_step=1024, n_cols=n_cols,
                           device="cpu")
    for k in ("tokens_useful", "tokens_computed", "badput_energy_overhead"):
        assert got[k] == ref[k]
    record = json.loads((ROOT / "experiments" / "bench" /
                         "e2e_energy.json").read_text())["paper-cim-120m"]
    share = CHIP.MC_TOL["fj_per_op_2048"] / record["fj_per_op"]
    for k in ("pj_per_token", "pj_per_useful_token"):
        assert abs(got[k] - ref[k]) <= share * ref[k], (k, got[k], ref[k])


# ----------------------------------------------------------- launchers
def _run_reference(module, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["launch"] + argv)
    module.main()
    return capsys.readouterr().out


def _masked(line):
    """``line`` with every number masked (timings, losses)."""
    return re.sub(r" *-?\d+(\.\d+)?(e[-+]?\d+)?", " #", line)


def test_launch_serve_demo_prints_reference_lines(capsys, monkeypatch):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--tokens", "17"]
    ref = _run_reference(jserve, argv, capsys, monkeypatch).splitlines()
    jarch = jax_get_config("qwen2-1.5b").reduced()
    jp = jax.tree.map(np.asarray,
                      jax_init_params(jax.random.PRNGKey(0), jarch))
    res = tserve.main(argv + ["--device", "cpu"], params=params_from_jax(
        jp, torch_get_config("qwen2-1.5b").reduced(), "cpu"))
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref) == 4
    assert got[1:] == ref[1:]                      # the step lines, exactly
    assert _masked(got[0]) == _masked(ref[0])      # TTFT, timing masked
    assert res["mode"] == "demo" and len(res["steps"]) == 17


def test_launch_serve_traffic_and_energy_lines(capsys, monkeypatch):
    argv = ["--arch", "paper-cim-120m", "--reduced", "--traffic", "4",
            "--tokens", "8", "--rate", "1000"]
    ref = _run_reference(jserve, argv, capsys, monkeypatch).splitlines()
    res = tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref)

    # prompt and generated counts come from the seeded traffic
    assert [re.sub(r", ttft.*", "", g) for g in got[:4]] == \
        [re.sub(r", ttft.*", "", r) for r in ref[:4]]
    # every number masked: the schedule follows the wall clock
    assert [_masked(g) for g in got] == [_masked(r) for r in ref]
    assert got[-1].startswith("energy: ") and ref[-1].startswith("energy: ")
    assert res["metrics"]["completed"] == 4


def test_launch_train_drill_matches_reference(capsys, monkeypatch, tmp_path):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "16", "--drill"]
    ref = json.loads(_run_reference(jtrain, argv + [
        "--ckpt-dir", str(tmp_path / "jax")], capsys, monkeypatch))
    rep = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "torch"),
                              "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(ref)
    assert set(got["energy"]) == set(ref["energy"])
    assert {k: got[k] for k in COUNTERS} == {k: ref[k] for k in COUNTERS}
    assert got["energy"]["tokens_computed"] == \
        ref["energy"]["tokens_computed"]
    assert len(rep["losses"]) == 6


def test_launch_train_prints_final_metrics(capsys, monkeypatch):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16"]
    ref = _run_reference(jtrain, argv, capsys, monkeypatch).splitlines()
    metrics = ttrain.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[-1].startswith("final: ") and ref[-1].startswith("final: ")
    assert [_masked(g) for g in got] == [_masked(r) for r in ref]
    assert np.isfinite(metrics["loss"])
