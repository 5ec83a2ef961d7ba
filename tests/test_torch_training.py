"""The port's training stack (``training.optimizer``, ``checkpoint``,
``fault``, ``trainer.train`` and ``data.pipeline``) against the JAX
package's, scenario by scenario of the reference's tests/test_training.py.

Tolerances: one AdamW and one Adafactor step on equal parameters and
gradients agree with JAX's to 2e-6 relative (f32 elementwise math; XLA
and torch round pow, sqrt and the schedule's cos in their last ulp), the
optimizer state and the metrics too; the int8 compression's codes are
equal and its residuals within 1e-6. The pipeline is held by contract
(``jax.random`` cannot be reproduced): shapes, dtypes, ranges, the
shifted labels, determinism and resumability, and ``FileTokens`` draws
the reference's windows exactly.
"""
import os
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.training import fault as jfault  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import fault  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.trainer import TrainConfig, train  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

RTOL = 2e-6


def _trees(seed=0):
    """Equal parameter and gradient trees (a matrix, a vector, a 3-D
    stack) as numpy, JAX and torch."""
    rng = np.random.default_rng(seed)
    p = {"w": rng.normal(size=(16, 8)).astype(np.float32),
         "b": rng.normal(size=(8,)).astype(np.float32),
         "s": {"k": rng.normal(size=(2, 4, 6)).astype(np.float32)}}
    g = tree_map(lambda a: (rng.normal(size=a.shape) * 0.3).astype(
        np.float32), p)
    return (p, g, tree_map(jnp.asarray, p), tree_map(jnp.asarray, g),
            tree_map(torch.tensor, p), tree_map(torch.tensor, g))


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=rtol * float(np.abs(np.asarray(j)).max()))


# ---------------------------------------------------------------- optimizer
def test_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 37, 100, 150):
        want = float(jopt.schedule(jopt.OptimizerConfig(**cfg),
                                   jnp.asarray(step)))
        got = float(topt.schedule(topt.OptimizerConfig(**cfg),
                                  torch.tensor(step)))
        assert got == pytest.approx(want, rel=RTOL, abs=0)


@pytest.mark.parametrize("algorithm", ["adamw", "adafactor"])
def test_one_step_on_equal_gradients_matches_jax(algorithm):
    """Two steps (the second with bias corrections and moments in play),
    clipping active, weight decay on the matrices."""
    _, _, jp, jg, tp, tg = _trees()
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0,
              weight_decay=0.1, algorithm=algorithm)
    jc, tc = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    assert jax.tree.map(np.shape, js) == tree_map(
        lambda t: tuple(t.shape), ts)
    for _ in range(2):
        jp, js, jm = jopt.apply_updates(jp, jg, js, jc)
        tp, ts, tm = topt.apply_updates(tp, tg, ts, tc)
        for k in ("w", "b"):
            _close(tp[k], jp[k])
        _close(tp["s"]["k"], jp["s"]["k"])
        for name in (("m", "v") if algorithm == "adamw" else ("vr", "vc")):
            _close(ts[name]["w"], js[name]["w"])
            _close(ts[name]["b"], js[name]["b"])
            _close(ts[name]["s"]["k"], js[name]["s"]["k"])
        assert int(ts["count"]) == int(js["count"])
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=RTOL)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=RTOL)


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=200,
                               weight_decay=0.0)
    state = topt.init_opt_state(params, cfg)
    for _ in range(150):
        grads = tree_map(lambda p: 2 * p, params)
        params, state, _ = topt.apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_adafactor_descends_and_state_is_small():
    params = {"w": torch.ones((64, 32)), "b": torch.zeros((32,))}
    cfg = topt.OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=100,
                               weight_decay=0.0, algorithm="adafactor")
    st = topt.init_opt_state(params, cfg)
    assert st["vr"]["w"].shape == (64,) and st["vc"]["w"].shape == (32,)
    p = params
    for _ in range(80):
        p, st, _ = topt.apply_updates(p, tree_map(lambda x: 2 * x, p), st,
                                      cfg)
    assert float(p["w"].abs().max()) < 0.3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compression_error_feedback_matches_jax(seed):
    """int8 codes equal to JAX's, the scales and residuals within 1e-6;
    the residual carries exactly what the codes lose, and the error is at
    most half a step."""
    rng = np.random.default_rng(seed)
    g = {"a": (rng.normal(size=(64,)) * 3.0).astype(np.float32)}
    e = {"a": (rng.normal(size=(64,)) * 0.01).astype(np.float32)}
    jq, js, je = jopt.compress_grads(tree_map(jnp.asarray, g),
                                     tree_map(jnp.asarray, e))
    tq, ts, te = topt.compress_grads(tree_map(torch.tensor, g),
                                     tree_map(torch.tensor, e))
    assert np.array_equal(tq["a"].numpy(), np.asarray(jq["a"]))
    assert float(ts["a"]) == pytest.approx(float(js["a"]), rel=1e-6)
    _close(te["a"], je["a"], 1e-6)
    rec = topt.decompress_grads(tq, ts)
    total = g["a"] + e["a"]
    assert float((rec["a"] + te["a"] - torch.tensor(total)).abs().max()) \
        < 1e-5
    assert float((rec["a"] - torch.tensor(total)).abs().max()) <= \
        float(ts["a"]) / 2 + 1e-6


# ---------------------------------------------------------------- pipeline
def test_pipeline_contract():
    """The reference's contract: a batch is a pure function of (seed,
    step), labels are the inputs shifted by one, ids lie in [0, V), the
    shapes, dtypes and mask are the reference's; the Zipf law's head
    (token 0 about 63%, as u^-0.7 - 1 < 1 for u > 2^(-1/0.7)) holds."""
    cfg = dict(global_batch=4, seq_len=16, vocab_size=100, seed=7)
    jb = jpipe.SyntheticLM(jpipe.DataConfig(**cfg)).batch_at(5)
    p1 = tpipe.SyntheticLM(tpipe.DataConfig(**cfg), device="cpu")
    p2 = tpipe.SyntheticLM(tpipe.DataConfig(**cfg), device="cpu")
    b5a, b5b = p1.batch_at(5), p2.batch_at(5)
    for k in ("inputs", "labels", "mask"):
        assert torch.equal(b5a[k], b5b[k])
        assert tuple(b5a[k].shape) == tuple(jb[k].shape)
    assert not torch.equal(p1.batch_at(6)["inputs"], b5a["inputs"])
    assert int(b5a["inputs"].max()) < 100 and int(b5a["inputs"].min()) >= 0
    assert torch.equal(b5a["inputs"][:, 1:], b5a["labels"][:, :-1])
    assert b5a["mask"].dtype == torch.float32 and bool(
        (b5a["mask"] == 1).all())
    big = tpipe.SyntheticLM(tpipe.DataConfig(64, 256, 32000, seed=0),
                            device="cpu").batch_at(0)["inputs"]
    share0 = float((big == 0).float().mean())
    assert abs(share0 - (1 - 2 ** (-1 / 0.7))) < 0.02
    emb = tpipe.SyntheticLM(tpipe.DataConfig(2, 8, 100, embedding_dim=32),
                            device="cpu").batch_at(0)
    assert tuple(emb["inputs"].shape) == (2, 8, 32)
    assert emb["inputs"].dtype == torch.float32
    assert abs(float(emb["inputs"].mean())) < 0.2
    assert abs(float(emb["inputs"].std()) - 1) < 0.2
    it = tpipe.iterate(p1, 5)
    assert torch.equal(next(it)["inputs"], b5a["inputs"])


def test_file_tokens_read_the_reference_windows(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 700, 5000).astype(
        np.uint16).tofile(path)
    cfg = dict(global_batch=3, seq_len=12, vocab_size=500, seed=4,
               source="file", path=path)
    jb = jpipe.make_pipeline(jpipe.DataConfig(**cfg)).batch_at(9)
    tb = tpipe.make_pipeline(tpipe.DataConfig(**cfg), device="cpu"
                             ).batch_at(9)
    for k in ("inputs", "labels", "mask"):
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5},
            "layers": [{"w": torch.full((2,), 7, dtype=torch.int32)}]}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 3, tree)
    ckpt.save_checkpoint(d, 7, tree_map(lambda x: x * 2, tree))
    assert ckpt.latest_step(d) == 7
    got, step = ckpt.restore_checkpoint(d, tree)
    assert step == 7
    assert torch.equal(got["a"], tree["a"] * 2)
    assert got["b"]["c"].dtype == torch.bfloat16 and torch.equal(
        got["b"]["c"], tree["b"]["c"] * 2)
    assert torch.equal(got["layers"][0]["w"], tree["layers"][0]["w"] * 2)
    target = os.path.join(d, "step_000000007", "arr_00000.npy")
    with open(target, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02")
    with pytest.raises(IOError):
        ckpt.restore_checkpoint(d, tree, step=7)
    with pytest.warns(UserWarning, match="step 7"):
        got, step = ckpt.restore_checkpoint(d, tree)   # falls back
    assert step == 3 and torch.equal(got["a"], tree["a"])
    with pytest.warns(UserWarning, match="corrupt"):
        assert ckpt.latest_step(d, verify=True) == 3
    # a torn write (no meta.json, not renamed) is never a candidate
    os.makedirs(os.path.join(d, "step_000000009.tmp0"))
    assert ckpt.latest_step(d) == 7
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, {**tree, "a": torch.zeros(3)}, step=3)


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in range(6):
        ckpt.save_checkpoint(d, s, {"x": torch.zeros((2,))}, keep=2)
    assert sorted(int(n.split("_")[1]) for n in os.listdir(d)) == [4, 5]


def test_async_two_tiers_and_fallback(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path / "durable"),
                               str(tmp_path / "local"), durable_every=4,
                               local_every=2)
    tree = _tree()
    for step in range(1, 9):
        w.maybe_save(step, tree_map(lambda x, s=step: x * s, tree))
    w.drain()
    assert w.stats["local"] == 4 and w.stats["durable"] == 2
    assert w.freshest() == [("local", 8), ("durable", 8)]
    state, step, tier = w.restore(tree)
    assert (step, tier) == (8, "local")
    assert torch.equal(state["a"], tree["a"] * 8)
    w.invalidate_local()
    state, step, tier = w.restore(tree)
    assert (step, tier) == (8, "durable")
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.save(9, tree)


# ---------------------------------------------------------------- fault
def test_failure_and_straggler_detection_match_jax():
    now = 1000.0
    for pkg in (jfault, fault):
        beats = [pkg.Heartbeat(h, 10, now - (100.0 if h == 2 else 1.0), 1.0)
                 for h in range(4)]
        beats[3].step_time_s = 10.0
        assert pkg.detect_failures(beats, now, timeout_s=60) == [2]
        assert pkg.detect_failures(beats, now, timeout_s=60,
                                   expected_hosts=6) == [2, 4, 5]
        assert pkg.detect_stragglers(beats) == [3]
        assert pkg.detect_stragglers(beats[:2]) == []


def test_heartbeat_board(tmp_path):
    board = fault.HeartbeatBoard(str(tmp_path / "hb"))
    board.beat(fault.Heartbeat(0, 5, time.time(), 0.5))
    board.beat(fault.Heartbeat(1, 5, time.time(), 0.6))
    with open(os.path.join(board.dir, "host_00002.json"), "w") as f:
        f.write("{torn")
    assert sorted(b.host for b in board.read_all()) == [0, 1]
    board.clear(1)
    assert [b.host for b in board.read_all()] == [0]


# ---------------------------------------------------------------- end to end
def test_train_descends_and_resumes(tmp_path, capsys):
    """``train`` on a reduced config: checkpoints, the loss falls, a longer
    run resumes from the last checkpoint (printing the tier) and ends
    where an uninterrupted run ends, bit for bit."""
    arch = get_config("qwen2-1.5b").reduced().replace(n_layers=2)
    pipe = tpipe.SyntheticLM(tpipe.DataConfig(
        global_batch=4, seq_len=32, vocab_size=arch.vocab_size, seed=1),
        device="cpu")
    opt = topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    d = str(tmp_path / "ck")
    first = train(arch, TrainConfig(steps=6, ckpt_dir=d, ckpt_every=3,
                                    log_every=1, opt=opt), pipe,
                  seed=0, heartbeat_dir=str(tmp_path / "hb"),
                  device="cpu")
    assert ckpt.latest_step(d) == 6 and np.isfinite(first["loss"])
    logged = [float(line.split()[4]) for line in
              capsys.readouterr().out.splitlines() if "loss" in line]
    assert logged[-1] < logged[0]
    resumed = train(arch, TrainConfig(steps=8, ckpt_dir=d, ckpt_every=3,
                                      log_every=100, opt=opt), pipe,
                    seed=0, device="cpu")
    assert "resumed from step 6 (durable tier)" in capsys.readouterr().out
    straight = train(arch, TrainConfig(steps=8, log_every=100, opt=opt),
                     pipe, seed=0, device="cpu")
    assert resumed == straight
    assert fault.HeartbeatBoard(str(tmp_path / "hb")).read_all()[0].step == 5
