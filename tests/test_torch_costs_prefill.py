"""The port's prefill ledgers against the JAX package's, entry by entry,
for all 11 configs at full width: one 64-token dispatch at batch 1, and
its op count per token against the energy smoke record, exactly (see
``test_torch_costs.py``)."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_configs  # noqa: E402
from test_torch_costs import check_ledger  # noqa: E402


@pytest.mark.parametrize("name", list_configs())
def test_prefill_ledger_matches_jax_at_full_width(name):
    ledger = check_ledger(name, "prefill")
    assert "unsited" not in ledger.sites()
