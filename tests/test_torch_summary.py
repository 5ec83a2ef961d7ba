"""The port's summary tables (``repro_torch.launch.summary``) against the
JAX package's ``repro.launch.summary``, compared as printed text (exact).

* ``dryrun_table``, ``energy_table`` and ``pareto_table`` print the same
  text as the reference's on the same rows (ok, skipped and error
  records in the reference's format) and on the committed
  ``experiments/bench/e2e_energy.json`` / ``e2e_pareto.json``, which are
  only read.
* ``roofline_table`` matches in every column but the two that read the
  HBM rate: the fusion-adjusted memory lower bound (the H100's
  ``HW.HBM_BW`` where the reference hard-codes a TPU's) and the dominant
  term's bracket, which compares that bound with the others.
* The port's own records (``trace_s`` in the place of ``compile_s``)
  render, and the CLI reads a directory of them.
"""
import pytest

pytest.importorskip("torch")

from repro.launch import summary as jsum  # noqa: E402
from repro_torch.launch import summary as tsum  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402

ENERGY = "experiments/bench/e2e_energy.json"
PARETO = "experiments/bench/e2e_pareto.json"


def _ok(arch, shape, t_c, t_m, t_x, args=3 << 30, outs=1 << 30):
    return {
        "arch": arch, "shape": shape, "mesh": "16x16", "cim": "off",
        "status": "ok", "compile_s": 12.5,
        "bytes_per_device": {"arguments": args, "outputs": outs,
                             "temps": 5 << 30, "aliased": outs,
                             "peak_est": args + (5 << 30)},
        "cost": {"flops_per_device": 1.25e15, "bytes_per_device": 7.5e11,
                 "collective_bytes_per_device": 3.2e9,
                 "collective_breakdown": {"all-gather": 3.2e9}},
        "roofline": {"arch": arch, "shape": shape, "mesh": "16x16",
                     "t_compute_s": t_c, "t_memory_s": t_m,
                     "t_collective_s": t_x,
                     "dominant": max((("compute", t_c), ("memory", t_m),
                                      ("collective", t_x)),
                                     key=lambda kv: kv[1])[0],
                     "model_flops": 3.1e17, "hlo/model": 1.34,
                     "roofline_fraction": 0.412}}


ROWS = [
    _ok("qwen2-1.5b", "train_4k", 2.0, 1.0, 0.5),
    _ok("gemma3-1b", "decode_32k", 1e-4, 3e-3, 2e-2, args=1 << 28),
    _ok("arctic-480b", "prefill_32k", 0.2, 0.9, 0.1, args=40 << 30,
        outs=1 << 33),
    {"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "16x16",
     "cim": "off", "status": "skipped",
     "reason": "skipped: pure full-attention arch at 512k context "
               "(see DESIGN.md §5)"},
    {"arch": "grok-1-314b", "shape": "train_4k", "mesh": "16x16",
     "cim": "off", "status": "error", "error": "RuntimeError: out of "
     "something quite long enough to be cut at sixty characters"},
]


def _print(fn, capsys, *args):
    fn(*args)
    return capsys.readouterr().out


def test_dryrun_table_matches_reference(capsys):
    assert _print(tsum.dryrun_table, capsys, ROWS) == \
        _print(jsum.dryrun_table, capsys, ROWS)


def test_roofline_table_matches_but_the_hbm_columns(capsys):
    ours = _print(tsum.roofline_table, capsys, ROWS).splitlines()
    ref = _print(jsum.roofline_table, capsys, ROWS).splitlines()
    assert len(ours) == len(ref) == 5
    assert ours[:2] == ref[:2]
    for o, r, d in zip(ours[2:], ref[2:], ROWS):
        oc, rc = o.split("|"), r.split("|")
        lb_col, dom_col = 5, 7
        assert [c for i, c in enumerate(oc) if i not in (lb_col, dom_col)] \
            == [c for i, c in enumerate(rc) if i not in (lb_col, dom_col)]
        b = d["bytes_per_device"]
        assert float(oc[lb_col]) == pytest.approx(
            (b["arguments"] + b["outputs"]) / HW.HBM_BW * 1e3, abs=5e-3)
    # the H100's HBM is faster than the reference's: a lower bound
    # below the reference's in every row that has one
    assert all(float(o.split("|")[5]) <= float(r.split("|")[5])
               for o, r in zip(ours[2:], ref[2:]))


def test_energy_and_pareto_tables_match_reference(capsys):
    assert _print(tsum.energy_table, capsys, ENERGY) == \
        _print(jsum.energy_table, capsys, ENERGY)
    ours = _print(tsum.pareto_table, capsys, PARETO)
    assert ours == _print(jsum.pareto_table, capsys, PARETO)
    assert "site_overrides" in ours


def test_port_records_render_and_cli_reads_them(tmp_path, capsys):
    import json

    rec = dict(ROWS[0], trace_s=3.5)
    del rec["compile_s"]
    (tmp_path / "qwen2-1.5b_train_4k_16x16.json").write_text(json.dumps(rec))
    (tmp_path / "qwen2-1.5b_long_500k_16x16.json").write_text(
        json.dumps(ROWS[3]))
    tsum.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert "| trace_s |" in out[0] and len(out) == 4
    assert out[3].startswith("| qwen2-1.5b | train_4k | 16x16 | ok | 3.5 |")
    tsum.main(["--dir", str(tmp_path), "--roofline"])
    assert len(capsys.readouterr().out.splitlines()) == 2   # no roofline rows
