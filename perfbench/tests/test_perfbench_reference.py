"""The plain reference against the port, at CPU size: every served token
of a closed-loop run is the reference's argmax, dispatch by dispatch with
all lanes (bitwise on the CPU), the first three train steps agree; and the
benchmark's sources keep to their imports."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import program  # noqa: E402
from perfbench.harness.drivers import closed_loop, train  # noqa: E402
from perfbench.harness.spec import HERE  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = 2 ** 33 + 5          # above 32 bits, as the driver's are


@pytest.mark.parametrize("workload", ["paper-chat", "mamba2-chat"])
def test_served_tokens_are_the_references_argmax(tmp_path, workload):
    cell = tiny.cell(tmp_path, workload)
    run, eng, sched, reqs, _ = closed_loop.drive(cell, SEED, 2.0, False, "cpu",
                                           program)
    assert run.steps > 10
    checked = closed_loop.check(cell, SEED, run, reqs, "cpu")
    assert checked["requests"] > 0 and checked["tokens"] > 50
    assert checked["served_gap"] == 0.0


def test_train_steps_follow_the_reference(tmp_path):
    cell = tiny.cell(tmp_path, "paper-train")
    run, _, _ = train.drive(cell, SEED, 0.5, False, "cpu", program)
    got = train.check(cell, SEED, run, "cpu")
    assert got["loss_gap"] == 0.0
    assert got["grad_gap"] < 1e-6
    assert got["delta_gap"] < 1e-6


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(HERE)): _imports(f) & {"jax", "jaxlib", "flax",
                                                   "repro"}
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((HERE / "reference").glob("*.py"))
    assert {str(f.name): _imports(f) & {"repro_torch", "repro"}
            for f in files} == {f.name: set() for f in files}
    code = ("import sys; import perfbench.reference.dense_lm, "
            "perfbench.reference.mamba2_lm, perfbench.reference.replay, "
            "perfbench.reference.optim; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    import importlib.util
    import types
    spec = importlib.util.spec_from_file_location("perfbench_entry",
                                                  HERE / "run.py")
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    fake = types.SimpleNamespace(modules={"repro_torch": 1,
                                          "repro_torch.models": 1,
                                          "jaxtyping": 1, "torch": 1})
    monkeypatch.setattr(entry, "sys", fake)
    assert entry.forbidden_modules() == []
    fake.modules.update({"repro.core": 1, "jax.numpy": 1})
    assert entry.forbidden_modules() == ["jax", "repro"]
