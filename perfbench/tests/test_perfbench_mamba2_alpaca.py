"""The cell ``mamba2-alpaca``: mamba2-1.3b served closed-loop under the
Alpaca mix. At CPU size every served token is the reference's argmax and
the reference in fp8 reads above the cell's limit; the SSM block's
readers read, on hand-built traces and on a traced run of the port, the
counts the run implies, and nothing where the program has no SSM scope.
The ``gpu`` case holds the same on the card."""
import json
import types

import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import program, report  # noqa: E402
from perfbench.harness.drivers import closed_loop  # noqa: E402
from perfbench.harness.spec import HERE, metric_reader  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = 2 ** 33 + 26          # above 32 bits, as a benchmark seed may be
CELL = "mamba2-alpaca"
SSM_READERS = ["ssm_recurrence_host_ms_per_token",
               "ssm_steps_per_prompt_token"]
# the serving readers the cell reports beside its own
SHARED = ["decode_step_ms", "prefill_ms_per_token",
          "launches_per_decode_step", "mfu.serve", "device_idle_pct.serve",
          "decode_enqueue_ms", "decode_fetch_wait_ms", "chunk_step_ms",
          "scheduler_self_ms", "graph_replay_share.serve"]


def test_the_cell_and_its_configuration_are_declared():
    bench = tiny.BENCH
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "mamba2-1.3b", "chat-alpaca8", 1)
    config = next(c for c in bench["configs"] if c["name"] == "mamba2-1.3b")
    assert config["reduced"] == []
    arch = json.loads((HERE.parent / config["file"]).read_text())["arch"]
    # the published widths: 48 layers, d_model 2048, 64 heads of 64,
    # d_state 128, conv 4
    assert (arch["n_layers"], arch["d_model"], arch["ssm_expand"],
            arch["ssm_headdim"], arch["ssm_state"], arch["conv_width"]) == (
        48, 2048, 2, 64, 128, 4)
    mix = json.loads((HERE / "traffic" / "chat-alpaca8.json").read_text())
    assert (mix["prompt_mean"], mix["output_mean"]) == (19.31, 58.45)
    assert (mix["engine"]["prefill_bucket_max"],
            mix["engine"]["prefill_token_budget"]) == (16, 16)
    limits = json.loads((HERE / "limits" / f"{CELL}.json").read_text())
    assert set(limits) == {"served_gap", "min_tokens"}
    reported = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
                if CELL in m.get("workloads", [CELL])}
    assert {"itl_p99_ms", "setup_s", "launches_per_prefill_token",
            "grmac_roofline.serve", *SSM_READERS, *SHARED} <= reported


def _drive(tmp_path, tracing, device="cpu", seconds=5.0):
    cell = tiny.cell(tmp_path, CELL)
    return cell, closed_loop.drive(cell, SEED, seconds, tracing, device,
                                   program)


def test_served_tokens_are_the_references_argmax_and_fp8_is_not(tmp_path):
    cell, (run, eng, sched, reqs, _) = _drive(tmp_path, False)
    assert run.steps > 10
    got = closed_loop.check(cell, SEED, run, reqs, "cpu", control="fp8")
    assert got["requests"] > 0 and got["tokens"] > 50
    assert got["served_gap"] == 0.0
    # the cell's own limit (not the CPU copy's coverage floor)
    limit = json.loads((HERE / "limits" / f"{CELL}.json").read_text())[
        "served_gap"]
    assert got["control_gap"] > limit


def _host(t0, bucket, layers):
    """A prefill chunk of ``bucket`` steps: the benchmark's span, the
    dispatch scope, each layer's recurrence holding its steps and a launch
    a step; then a decode step's one step, outside every chunk."""
    events = [(t0, t0 + 1000, "Engine.advance_prefill"),
              (t0 + 1, t0 + 999, f"engine.prefill[bucket={bucket}]")]
    for i in range(layers):
        a = t0 + 10 + 100 * i
        events.append((a, a + 90, "ssm.recurrence"))
        for k in range(bucket):
            events += [(a + 1 + 2 * k, a + 2 + 2 * k, "ssm.step"),
                       (a + 1 + 2 * k, a + 2 + 2 * k, "cudaLaunchKernel")]
    return events + [(t0 + 2000, t0 + 2100, "engine.decode[sample=False]"),
                     (t0 + 2011, t0 + 2012, "ssm.step")]


def _ctx(events, prompt_tokens, layers, launches=0):
    return types.SimpleNamespace(
        trace=types.SimpleNamespace(
            _cpu=sorted(events),
            launches_in={"Engine.advance_prefill": launches}),
        work={"prompt_tokens": prompt_tokens}, arch={"n_layers": layers})


def test_ssm_readers_on_a_hand_built_trace():
    # two chunks of 16 and 8 steps over 2 layers that prefilled 16 and 3
    events = _host(0, 16, 2) + _host(5000, 8, 2)
    ctx = _ctx(events, 19, 2, launches=2 * (16 + 8))
    # every step of a bucket runs, padded or not: 24 steps for 19 tokens
    # (the decodes' steps left out)
    assert metric_reader("ssm_steps_per_prompt_token")(ctx) == \
        pytest.approx(24 / 19)
    # four recurrences of 90 us
    assert metric_reader("ssm_recurrence_host_ms_per_token")(ctx) == \
        pytest.approx(4 * 90e-3 / 19)
    assert metric_reader("launches_per_prefill_token")(ctx) == \
        pytest.approx(48 / 19)


@pytest.mark.parametrize("name", SSM_READERS)
def test_ssm_readers_need_their_scopes(name):
    bare = [e for e in _host(0, 16, 2) if not e[2].startswith("ssm.")]
    assert metric_reader(name)(_ctx(bare, 16, 2)) is None
    assert metric_reader(name)(_ctx(_host(0, 16, 2), 0, 2)) is None
    assert metric_reader(name)(_ctx(_host(0, 16, 2), 16, 2)) > 0


def test_launches_per_prefill_token_needs_prompt_tokens():
    read = metric_reader("launches_per_prefill_token")
    assert read(_ctx([], 0, 2, launches=5)) is None
    assert read(_ctx([], 10, 2, launches=0)) == 0.0


def _implied(run, ts, te):
    """(prompt tokens, padded steps a layer, host ms of the spans) of the
    chunks in the slice."""
    spans = [(got, bucket, t - s) for s, t, got, bucket, _
             in run.prefill_spans if ts <= s and t <= te]
    return (sum(g for g, _, _ in spans), sum(b for _, b, _ in spans),
            1e3 * sum(d for _, _, d in spans))


def _traced(cell, run):
    ts, te = run.slice
    return report.per_layer(cell, closed_loop._context(cell, run, ts, te))


def test_traced_run_reads_the_ssm_block(tmp_path):
    cell, (run, *_) = _drive(tmp_path, True, seconds=30.0)
    got = _traced(cell, run)
    tokens, steps, span_ms = _implied(run, *run.slice)
    assert tokens > 0
    value = {k: v["value"] for k, v in got.items()}
    assert value["ssm_steps_per_prompt_token"] == pytest.approx(
        steps / tokens)
    assert value["ssm_steps_per_prompt_token"] >= 1.0
    # the loop lies inside the chunk's dispatch, inside its span
    assert 0 < value["ssm_recurrence_host_ms_per_token"] < span_ms / tokens
    # the CPU launches no CUDA kernel
    assert value["launches_per_prefill_token"] == 0.0
    assert set(SHARED) <= set(value), sorted(value)


@pytest.mark.gpu
def test_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, (run, eng, sched, reqs, _) = _drive(tmp_path / "a", False, "cuda",
                                             seconds=4.0)
    got = closed_loop.check(cell, SEED, run, reqs, "cuda", control="fp8")
    assert got["served_gap"] == 0.0 and got["tokens"] > 50
    assert got["control_gap"] > json.loads(
        (HERE / "limits" / f"{CELL}.json").read_text())["served_gap"]
    del eng, sched
    cell, (run, *_) = _drive(tmp_path / "b", True, "cuda", seconds=30.0)
    value = {k: v["value"] for k, v in _traced(cell, run).items()}
    tokens, steps, _ = _implied(run, *run.slice)
    assert value["ssm_steps_per_prompt_token"] == pytest.approx(
        steps / tokens)
    assert value["ssm_recurrence_host_ms_per_token"] > 0
    assert value["launches_per_prefill_token"] > 0
    assert value["launches_per_decode_step"] > 0
    assert {"grmac_roofline.serve", *SHARED} <= set(value), sorted(value)
