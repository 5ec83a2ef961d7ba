"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (the harness's look for a card skipped,
CPU size, the cell's own limits), and the control (the reference in the
precision below the configuration's, put in the port's place) reads
above them."""
import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import program  # noqa: E402
from perfbench.harness.drivers import closed_loop, train  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = 2 ** 34 + 11
CHATS = ["paper-chat", "mamba2-chat"]


def _altered_token(eng, sched):
    """Every seventh fetch of ids comes back one off."""
    fetch, n = eng._fetch, [0]

    def wrong(ids):
        out = fetch(ids)
        n[0] += 1
        return (out + 1) % 500 if n[0] % 7 == 0 else out
    eng._fetch = wrong


def _state_unchanged(eng, sched):
    """Every decode step leaves the caches as it found them."""
    decode = eng._decode

    def frozen(*a, **k):
        saved = [{n: t.clone() for n, t in layer.items()}
                 for layer in eng.cache["layers"]]
        out = decode(*a, **k)
        for layer, old in zip(eng.cache["layers"], saved):
            layer.update(old)
        return out
    eng._decode = frozen


def _serve(tmp_path, workload, hook):
    cell = tiny.cell(tmp_path, workload)
    run, eng, sched, reqs, _ = closed_loop.drive(cell, SEED, 2.0, False, "cpu",
                                           program, hook=hook)
    checked = closed_loop.check(cell, SEED, run, reqs, "cpu")
    return closed_loop.result_line(checked, cell.limits)


@pytest.mark.parametrize("workload", CHATS)
@pytest.mark.parametrize("fault", [None, _altered_token, _state_unchanged])
def test_serving_faults_fail_the_check(tmp_path, workload, fault):
    correct, checks = _serve(tmp_path, workload, fault)
    assert correct is (fault is None), checks


def _train(tmp_path, hook):
    cell = tiny.cell(tmp_path, "paper-train")
    run, _, _ = train.drive(cell, SEED, 0.3, False, "cpu", program,
                            hook=hook)
    return train.result_line(train.check(cell, SEED, run, "cpu"),
                             cell.limits)


def _unchanged(fn):
    return lambda p, o, b: (p, o, fn(p, o, b)[2])


def _half_batch(fn):
    return lambda p, o, b: fn(p, o, {k: v[:v.shape[0] // 2]
                                     for k, v in b.items()})


@pytest.mark.parametrize("fault", [None, _unchanged, _half_batch])
def test_training_faults_fail_the_check(tmp_path, fault):
    correct, checks = _train(tmp_path, fault)
    assert correct is (fault is None), checks


def test_fp8_control_reads_above_the_limit(tmp_path):
    cell = tiny.cell(tmp_path, "mamba2-chat")
    run, eng, sched, reqs, _ = closed_loop.drive(cell, SEED, 2.0, False, "cpu",
                                           program)
    got = closed_loop.check(cell, SEED, run, reqs, "cpu", control="fp8")
    assert got["served_gap"] <= cell.limits["served_gap"]
    assert got["control_gap"] > cell.limits["served_gap"]


@pytest.mark.gpu
def test_tf32_control_reads_above_the_limit(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")
    cell = tiny.cell(tmp_path, "paper-chat")
    run, eng, sched, reqs, _ = closed_loop.drive(cell, SEED, 4.0, False, "cuda",
                                           program)
    got = closed_loop.check(cell, SEED, run, reqs, "cuda", control="tf32")
    assert got["served_gap"] <= cell.limits["served_gap"]
    assert got["control_gap"] > cell.limits["served_gap"]
