"""The port's train ledgers against the JAX package's, entry by entry, for
the full-width configs whose train forward the port has (every config
without RG-LRU or SSM blocks), and their op count per token against the
energy smoke record, exactly (see ``test_torch_costs.py``). The other two
raise the port's ``NotImplementedError``: their train forms come with the
training slice, and a partial ledger would under-count."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_configs  # noqa: E402
from repro_torch.core import costs as TC  # noqa: E402
from repro_torch.serving.engine import energy_report  # noqa: E402
from test_torch_costs import check_ledger, full_width  # noqa: E402

RECURRENT = ("mamba2-1.3b", "recurrentgemma-9b")


@pytest.mark.parametrize("name", [n for n in list_configs()
                                  if n not in RECURRENT])
def test_train_ledger_matches_jax_at_full_width(name):
    ledger = check_ledger(name, "train")
    assert "unsited" not in ledger.sites()


@pytest.mark.parametrize("name", RECURRENT)
def test_train_trace_of_recurrent_blocks_raises(name):
    arch = full_width(name)[1]
    with pytest.raises(NotImplementedError, match="training slice"):
        TC.trace_train(arch)
    with pytest.raises(NotImplementedError, match="training slice"):
        energy_report(arch.reduced(), device="cpu")
