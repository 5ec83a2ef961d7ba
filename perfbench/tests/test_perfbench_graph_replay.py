"""``graph_replay_share.serve``: the share of the engine's dispatch scopes
in a traced slice that hold a ``cudaGraphLaunch``, on hand-built traces:
every dispatch replayed, some, none (an eager program), and no dispatch
scope at all (nothing to read)."""
import types

import pytest

from perfbench.harness.spec import metric_reader

READ = metric_reader("graph_replay_share.serve")


def _ctx(events):
    return types.SimpleNamespace(trace=types.SimpleNamespace(
        _cpu=sorted(events)))


def _dispatch(t0, name, replayed):
    """A dispatch scope at ``t0`` and what runs inside it: a graph launch,
    or an eager forward's kernel launches."""
    inner = ([(t0 + 3, t0 + 4, "cudaGraphLaunch")] if replayed else
             [(t0 + 2, t0 + 3, "cudaLaunchKernel"),
              (t0 + 5, t0 + 6, "cudaLaunchKernel")])
    return [(t0, t0 + 10, name), (t0 + 1, t0 + 2, "engine.h2d")] + inner


DECODE, CHUNK = "engine.decode[sample=False]", "engine.prefill[bucket=64]"


@pytest.mark.parametrize("replayed, share", [
    ((True, True, True), 100.0),
    ((True, False, True), 200.0 / 3),
    ((False, False, False), 0.0),
])
def test_share_of_dispatches_holding_a_graph_launch(replayed, share):
    names = (DECODE, CHUNK, DECODE)
    events = [(0, 40, "sched.step"), (30, 32, "engine.fetch")]
    for i, (name, r) in enumerate(zip(names, replayed)):
        events += _dispatch(100 * (i + 1), name, r)
    # a launch outside every dispatch scope counts for none
    events.append((500, 501, "cudaGraphLaunch"))
    assert READ(_ctx(events)) == pytest.approx(share)


def test_nothing_without_dispatch_scopes():
    assert READ(_ctx([(0, 10, "sched.step"),
                      (3, 4, "cudaGraphLaunch")])) is None
