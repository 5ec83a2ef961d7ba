"""The program's scopes as the harness reads them (``harness.scopes``, the
scope metrics' readers, ``trace_scopes.py``): on a hand-built trace of two
threads, each device operation goes to one innermost scope of its
launching thread or to "no scope", self time leaves out the child scopes
and an idle gap's label names the scopes open; the readers return nothing
without their scopes; and on the CPU, a traced run of paper-chat reads
them from the port's own scopes."""
import types

import pytest

torch = pytest.importorskip("torch")

from perfbench import trace_scopes  # noqa: E402
from perfbench.harness import program, report, trace  # noqa: E402
from perfbench.harness.drivers import closed_loop  # noqa: E402
from perfbench.harness.scopes import (NO_SCOPE, Device, Host,  # noqa: E402
                                      Scopes)
from perfbench.harness.spec import metric_reader  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

READERS = ["decode_enqueue_ms", "decode_fetch_wait_ms", "chunk_step_ms",
           "scheduler_self_ms"]
MAIN, GRAD = 1, 2


def _host():
    """A decode step on the main thread (its dispatch, a projection's
    pre-scale, the fetch), a scheduler step holding a prefill chunk, and
    a backward on autograd's thread, with their launches."""
    s, sp, op, ln = "scope", "span", "op", "launch"
    return [
        Host(0, 100, "sched.step", MAIN, s),
        Host(1, 99, "Engine.step", MAIN, sp),
        Host(5, 60, "engine.decode[sample=False]", MAIN, s),
        Host(6, 9, "engine.h2d", MAIN, s),
        Host(10, 50, "model.layer", MAIN, s),
        Host(12, 30, "cim_q_m8_k768_n768", MAIN, s),
        Host(13, 20, "cim.prescale", MAIN, s),
        Host(14, 16, "aten::view", MAIN, op),
        Host(16, 17, "cudaLaunchKernel", MAIN, ln, 101),
        Host(40, 41, "cudaLaunchKernel", MAIN, ln, 102),
        Host(70, 95, "engine.fetch", MAIN, s),
        Host(80, 81, "cudaMemcpyAsync", MAIN, ln, 103),
        Host(110, 150, "sched.step", MAIN, s),
        Host(112, 140, "Engine.advance_prefill", MAIN, sp),
        Host(114, 138, "engine.prefill[bucket=128]", MAIN, s),
        Host(115, 116, "aten::mm", MAIN, op),
        Host(116, 117, "cuLaunchKernel", MAIN, ln, 104),
        Host(190, 400, "train.backward", MAIN, s),
        Host(200, 300, "model.layer", GRAD, s),
        Host(210, 250, "cim.pack", GRAD, s),
        Host(220, 221, "cudaLaunchKernel", GRAD, ln, 201),
        Host(260, 261, "cudaLaunchKernel", GRAD, ln, 202),
        # autograd's thread outside its scopes, the main one in its own
        Host(310, 311, "cudaLaunchKernel", GRAD, ln, 203),
    ]


DEVICE = [Device(20, 25, "absmax", 101), Device(45, 52, "copy", 102),
          Device(85, 96, "Memcpy DtoH", 103), Device(120, 140, "grmac", 104),
          Device(230, 243, "pack", 201), Device(270, 287, "ste", 202),
          Device(320, 339, "accumulate", 203), Device(400, 423, "lost", 999)]


def test_each_device_operation_has_one_scope():
    sc = Scopes(_host(), DEVICE)
    by = sc.device_by_scope()
    us = 1e-6
    assert by == pytest.approx({
        "cim.prescale": 5 * us, "model.layer": (7 + 17) * us,
        "engine.fetch": 11 * us, "engine.prefill[bucket=128]": 20 * us,
        "cim.pack": 13 * us, NO_SCOPE: (19 + 23) * us})
    assert sum(by.values()) == pytest.approx(
        sum(d.end - d.start for d in DEVICE) * us)
    assert sc.device_seconds("cim.prescale", under="engine.decode[") == \
        pytest.approx(5 * us)
    assert sc.device_seconds("model.layer", under="train.") == 0.0


def test_self_time_leaves_out_child_scopes():
    hs = Scopes(_host()).host_seconds()
    # model.layer: 40 us holding a 18 us projection, 100 us holding the
    # 40 us packing on the other thread
    total, own, n = hs["model.layer"]
    assert (n, total, own) == (2, pytest.approx(140e-6),
                               pytest.approx(82e-6))
    assert hs["cim_q"][:2] == pytest.approx([18e-6, 11e-6])
    assert hs["train.backward"][:2] == pytest.approx([210e-6, 210e-6])


@pytest.mark.parametrize("t,label", [
    (15, "Engine.step: sched.step > engine.decode[sample=False] > "
         "model.layer > cim_q > cim.prescale: aten::view"),
    (45, "Engine.step: sched.step > engine.decode[sample=False] > "
         "model.layer"),
    (105, "outside the spans"),
    (230, "outside the spans: model.layer > cim.pack"),
])
def test_gap_label_takes_the_innermost_scopes(t, label):
    sc = Scopes(_host() + [Host(229, 231, "aten::abs", GRAD, "op")])
    want = label if t != 230 else label + ": aten::abs"
    assert sc.label(t) == want


def test_label_is_capped():
    deep = [Host(0, 100, "Engine.step", MAIN, "span")] + [
        Host(i, 100 - i, f"scope.{i:02d}", MAIN, "scope") for i in range(40)]
    assert len(Scopes(deep).label(50)) == 160


def _ctx(host):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        _cpu=sorted((h.start, h.end, h.name) for h in host)))


@pytest.mark.parametrize("name", READERS)
def test_readers_need_their_scopes(name):
    bare = [h for h in _host() if h.kind != "scope"]
    assert metric_reader(name)(_ctx(bare)) is None
    assert metric_reader(name)(_ctx(_host())) > 0


def test_readers_on_the_hand_built_trace():
    ctx = _ctx(_host())
    assert metric_reader("decode_enqueue_ms")(ctx) == pytest.approx(0.055)
    assert metric_reader("decode_fetch_wait_ms")(ctx) == pytest.approx(0.025)
    assert metric_reader("chunk_step_ms")(ctx) == pytest.approx(0.040)
    # step 1: 100 us less the span's 98; step 2: 40 us less the span's 28
    assert metric_reader("scheduler_self_ms")(ctx) == pytest.approx(
        (2 + 12) / 2 * 1e-3)


def test_traced_run_reads_the_ports_scopes(tmp_path, monkeypatch):
    kept = []
    make = trace.profiler
    monkeypatch.setattr(trace, "profiler",
                        lambda: kept.append(make()) or kept[-1])
    cell = tiny.cell(tmp_path, "paper-chat")
    run, *_ = closed_loop.drive(cell, 2 ** 34 + 11, 30.0, True, "cpu",
                                program)
    ts, te = run.slice
    got = report.per_layer(cell, closed_loop._context(cell, run, ts, te))
    assert set(READERS) <= set(got), got
    assert got["decode_enqueue_ms"]["value"] < got["decode_step_ms"]["value"]
    assert got["chunk_step_ms"]["value"] > got["scheduler_self_ms"]["value"]
    line = trace_scopes.report(kept[-1], closed_loop.SPANS)
    names = {r[0] for r in line["host_by_scope"]}
    assert {"sched.step", "engine.fetch", "model.layer", "cim.prescale",
            "cim_mlp"} <= names
    assert line["decode_step"]["steps"] == line["steps"]["Engine.step"] > 0
