"""The port's train ledgers against the JAX package's, entry by entry, for
every full-width config, and their op count per token against the energy
smoke record, exactly (see ``test_torch_costs.py``). The RG-LRU and SSM
configs trace their train forms (the associative scan, the chunked SSD),
and ``energy_report`` prices all three of their phases as the
reference's does."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_configs  # noqa: E402
from repro.serving.engine import energy_report as jax_energy_report  # noqa: E402
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
    """Once raising (the train forms were not ported), now the recurrent
    configs' train ledgers equal the reference's entry by entry, and
    ``energy_report`` of their reduced configs has the reference's three
    phases with its op counts per token, exactly (the pJ are Monte-Carlo
    estimates: see ``test_torch_energy.py``)."""
    ledger = check_ledger(name, "train")
    assert "unsited" not in ledger.sites()
    jarch, tarch = (a.reduced() for a in full_width(name))
    got = energy_report(tarch, device="cpu", n_cols=1 << 8)
    want = jax_energy_report(jarch, n_cols=1 << 8)
    assert sorted(got["phases"]) == sorted(want["phases"]) == [
        "decode", "prefill", "train"]
    for phase in ("decode", "prefill", "train"):
        g, w = got["phases"][phase], want["phases"][phase]
        assert g["ops_per_token"] == w["ops_per_token"]
        assert g["analog_ops_per_token"] == w["analog_ops_per_token"]
        assert sorted(g["sites"]) == sorted(w["sites"])
