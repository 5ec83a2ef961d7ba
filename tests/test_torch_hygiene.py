"""The port and ``chip_smoke.py`` stand alone: they import neither JAX nor
anything of the JAX package ``repro`` (the machine with the card has no
JAX)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (imported beside torch, as in every port test)

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s*$|\s+as\b)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py"]


def test_no_jax_or_reference_imports_in_the_port_sources():
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in _port_files()
           for m in _FORBIDDEN.finditer(p.read_text())]
    assert bad == []


def test_forbidden_import_pattern():
    for line in ("import jax", "from jax import numpy", "import repro.core",
                 "from repro.kernels import ops", "from repro import x",
                 "import repro"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch.core", "from repro_torch import x",
                 "import jaxlib_free_helper"):
        assert not _FORBIDDEN.search(line), line


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.convert, repro_torch.kernels.grmac_matmul; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok"' not in proc.stdout
