"""The port's examples (``python -m repro_torch.examples.<name>``), each
run as a subprocess with ``--device cpu`` and small arguments: each exits
0. ``design_explorer``'s chosen design (format and architecture) and
``site_pareto``'s ``site_overrides`` equal the lines the reference's
``examples/*.py`` print for the same arguments; the fJ/Op beside the
chosen design is a Monte-Carlo estimate from another generator and is
not compared. Without ``--device`` an example asks for the card, and
refuses to run where there is none.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH="src" + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, env=env, timeout=timeout)
    return r


def _port(name, *args):
    r = _run(["-m", f"repro_torch.examples.{name}", *args])
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _ref(name, *args):
    r = _run([f"examples/{name}.py", *args])
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_quickstart():
    out = _port("quickstart", "--device", "cpu", "--n-cols", "2048")
    assert "GR-MAC [row ]" in out and "GR-CIM" in out


def test_serve_decode():
    out = _port("serve_decode", "--small", "--steps", "4", "--device", "cpu")
    assert "generated:" in out and "pJ/token" in out


def test_train_lm(tmp_path):
    out = _port("train_lm", "--small", "--steps", "2", "--batch", "2",
                "--seq", "32", "--ckpt", str(tmp_path), "--device", "cpu")
    assert "final:" in out
    assert os.listdir(tmp_path)       # the last step saved


def _optimal(out):
    line = [x for x in out.splitlines() if x.startswith("==> optimal")][0]
    return re.sub(r" at [0-9.]+ fJ/Op$", "", line)


def test_design_explorer_chooses_the_reference_design():
    args = ("--sqnr", "35", "--dr", "60")
    assert _optimal(_port("design_explorer", *args, "--device", "cpu")) == \
        _optimal(_ref("design_explorer", *args))


def _overrides(out):
    lines = out.splitlines()
    i = lines.index("ready-to-apply site_overrides:")
    return lines[i + 1:]


def test_site_pareto_overrides_equal_reference():
    args = ("--arch", "paper-cim-120m", "--n-cols", "256")
    got = _overrides(_port("site_pareto", *args, "--device", "cpu"))
    assert got and got == _overrides(_ref("site_pareto", *args))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_examples_refuse_without_a_card():
    r = _run(["-m", "repro_torch.examples.serve_decode", "--small",
              "--steps", "1"])
    assert r.returncode != 0 and "no CUDA device" in r.stderr
