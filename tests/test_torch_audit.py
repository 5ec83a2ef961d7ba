"""The port's ledger audit (``repro_torch.analysis.op_audit``): every
(config, phase) audits clean at full width on ``meta`` with the
``contracts``, ``calls`` and ``macs`` of the JAX package's committed
golden (``experiments/audit/audit_report.json``); the marker grammar;
a live ``jaxpr_audit.audit_phase`` against the port; a seeded untagged
matmul caught with its file and line; the train phase's STE backward
declared digital and its other backward contractions counted as
transposes. The recurrent configs' 128-token prefills are in
``test_torch_audit_prefill.py`` (their per-token loops take most of the
time).

Raw contraction counts (``dot_generals``, ``transposes``) are aten
operations here and jaxpr equations there: they are not compared.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.analysis.jaxpr_audit import audit_phase as jax_audit_phase  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.ops import site_marker as jax_site_marker  # noqa: E402
from repro_torch.analysis import op_audit  # noqa: E402
from repro_torch.analysis.op_audit import MARKER_RE, audit_arch, audit_phase  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.core import scopes  # noqa: E402
from repro_torch.kernels.ops import site_marker  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

GOLDEN = json.loads((Path(__file__).resolve().parents[1] / "experiments"
                     / "audit" / "audit_report.json").read_text())["configs"]
# the recurrent prefills run in test_torch_audit_prefill.py
SLOW = {("mamba2-1.3b", "prefill"), ("recurrentgemma-9b", "prefill")}
CASES = [(name, phase) for name in list_configs()
         for phase in ("prefill", "decode", "train")
         if (name, phase) not in SLOW]


def check_against_golden(name, phase):
    res = audit_phase(get_config(name), phase)
    want = GOLDEN[name]["phases"][phase]
    assert res["untagged"] == 0, res["untagged_details"][:3]
    assert res["ledger_mismatches"] == 0, (
        res["ledger_mismatch_details"][:3], res["unknown_site_details"][:3],
        res["opaque_details"])
    assert res["calls"] == want["calls"]
    assert res["macs"] == want["macs"]
    assert res["contracts"] == want["contracts"]
    assert res["tagged_values"] == want["tagged_values"] == want["calls"]
    return res


def test_marker_grammar_roundtrip():
    m = MARKER_RE.fullmatch(site_marker("attn_qkv", 4, 896, 1152))
    assert m is not None
    assert m.group("site") == "attn_qkv"
    assert tuple(map(int, (m.group("m"), m.group("k"), m.group("n")))) == \
        (4, 896, 1152)
    m = MARKER_RE.fullmatch(site_marker("moe_expert", 8, 64, 128))
    assert m is not None and m.group("site") == "moe_expert"
    for args in (("attn_qkv", 4, 896, 1152), (None, 1, 2, 3),
                 ("moe_expert", 8, 64, 128)):
        assert site_marker(*args) == jax_site_marker(*args)


def test_scopes_are_a_thread_local_stack():
    assert scopes.current() == []
    with scopes.named_scope("a"), scopes.named_scope("b"):
        assert scopes.current() == ["a", "b"]
    assert scopes.current() == []


@pytest.mark.parametrize("name,phase", CASES)
def test_audit_equals_the_golden(name, phase):
    check_against_golden(name, phase)


def test_live_jaxpr_audit_equals_the_port():
    """JAX's own audit, traced now, and the port's: the same contracts,
    calls and MACs, both clean (paper-cim-120m decode)."""
    want = jax_audit_phase(jax_get_config("paper-cim-120m"), "decode")
    got = audit_phase(get_config("paper-cim-120m"), "decode")
    assert want["untagged"] == got["untagged"] == 0
    assert want["ledger_mismatches"] == got["ledger_mismatches"] == 0
    for key in ("contracts", "calls", "macs", "tagged_values"):
        assert got[key] == want[key], key


def test_seeded_untagged_matmul_is_caught_with_its_source(monkeypatch):
    """An untagged contraction smuggled into a model layer fails the audit
    and names this file and line as its source; the ledger cross-check
    stays clean (untagged and mismatch are independent failure axes)."""
    arch = get_config("paper-cim-120m").reduced()
    orig = L.rmsnorm

    def leaky_rmsnorm(p, x, eps=1e-6):
        out = orig(p, x, eps)
        return out @ torch.eye(out.shape[-1], dtype=out.dtype,
                               device=out.device)   # the leak

    monkeypatch.setattr(L, "rmsnorm", leaky_rmsnorm)
    res = audit_phase(arch, "decode")
    assert res["untagged"] > 0
    leak = res["untagged_details"][0]
    assert leak["primitive"] in ("mm", "bmm", "matmul")
    assert leak["file"] and leak["file"].endswith("test_torch_audit.py")
    assert isinstance(leak["line"], int) and leak["line"] > 0
    assert res["ledger_mismatches"] == 0, res["ledger_mismatch_details"]
    assert audit_arch(arch, ("decode",))["failures"] == res["untagged"]


def test_train_phase_counts_ste_backward_digital_and_transposes():
    """The train phase runs the backward: paper-cim-120m's 85 CIM calls
    each add two STE products under ``dig_ste_bwd`` (declared digital)
    beside the attention einsums; the backward of the digital einsums is
    counted as transposes, never against the ledger."""
    res = audit_phase(get_config("paper-cim-120m").reduced(), "train")
    assert res["untagged"] == 0 and res["ledger_mismatches"] == 0
    calls = res["calls"]
    attn = res["declared_digital"] - 2 * calls     # the forward's einsums
    assert attn > 0
    assert res["transposes"] == 2 * attn           # two grads each
    assert res["tagged_values"] == calls
    assert res["dot_generals"] == calls + 2 * calls + 3 * attn


def test_a_kernel_launch_in_an_audit_is_reported_opaque(monkeypatch):
    """A GR-MAC kernel launch seen during the trace hides its
    contraction: it is reported as opaque and counts as a mismatch."""
    from repro_torch.kernels.grmac_matmul import grmac_matmul_cuda

    real = op_audit._run

    def run_and_launch(arch, phase):
        real(arch, phase)
        grmac_matmul_cuda.launches += 1

    monkeypatch.setattr(op_audit, "_run", run_and_launch)
    before = grmac_matmul_cuda.launches
    try:
        res = audit_phase(get_config("paper-cim-120m").reduced(), "decode")
    finally:
        grmac_matmul_cuda.launches = before
    assert res["opaque_details"] and res["ledger_mismatches"] == 1
