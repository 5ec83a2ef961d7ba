"""``ssm_scan_share``: the share of the SSM block's ``ssm.recurrence``
scopes inside the engine's prefill dispatches that hold an ``ssm.scan``
scope, on hand-built traces: every one does, some do, none does (a
program that loops step by step), and no recurrence inside a prefill
dispatch at all (nothing to read)."""
import types

import pytest

from perfbench.harness.spec import metric_reader

READ = metric_reader("ssm_scan_share")


def _ctx(events):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        _cpu=sorted(events)))


def _layer(t0, scanned):
    """A layer's ``ssm.recurrence`` at ``t0``: one scan launch, or a loop
    of ``ssm.step`` scopes."""
    inner = ([(t0 + 2, t0 + 6, "dig_ssm_ssd"), (t0 + 3, t0 + 5, "ssm.scan")]
             if scanned else
             [(t0 + 1 + 2 * i, t0 + 2 + 2 * i, "ssm.step") for i in range(4)])
    return [(t0, t0 + 10, "ssm.recurrence")] + inner


def _chunk(t0, scanned):
    """A prefill dispatch at ``t0`` over layers whose recurrence is a scan
    or a loop, as ``scanned`` says."""
    events = [(t0, t0 + 20 * len(scanned) + 10, "engine.prefill[bucket=16]")]
    for i, s in enumerate(scanned):
        events += [(t0 + 5 + 20 * i, t0 + 20 + 20 * i, "model.layer")]
        events += _layer(t0 + 6 + 20 * i, s)
    return events


@pytest.mark.parametrize("scanned, share", [
    (((True, True), (True, True)), 100.0),
    (((True, False), (False, False)), 25.0),
    (((False, False), (False, False)), 0.0),
])
def test_share_of_recurrences_holding_a_scan(scanned, share):
    events = [(0, 40, "sched.step"), (50, 60, "engine.decode[sample=False]"),
              (52, 53, "ssm.step"), (52.2, 52.8, "ssm.scan")]
    for i, chunk in enumerate(scanned):
        events += _chunk(100 * (i + 1), chunk)
    # a recurrence outside every prefill dispatch counts for none
    events += _layer(500, False)
    assert READ(_ctx(events)) == pytest.approx(share)


def test_nothing_without_a_recurrence_in_a_prefill_dispatch():
    events = [(0, 40, "engine.prefill[bucket=8]"), (5, 10, "model.layer")]
    events += _layer(100, True)
    assert READ(_ctx(events)) is None
