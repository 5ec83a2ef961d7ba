"""The ledger audit of the recurrent configs' 128-token prefills
(mamba2-1.3b, recurrentgemma-9b) at full width on ``meta`` against the
committed golden: the per-token loops of their prefills issue most of the
audit's operations, so they run in a file of their own (the rest is
``test_torch_audit.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from test_torch_audit import SLOW, check_against_golden  # noqa: E402


@pytest.mark.parametrize("name,phase", sorted(SLOW))
def test_audit_equals_the_golden(name, phase):
    check_against_golden(name, phase)
