"""The engine's rule for replaying its dispatches from CUDA graphs
(``serving.graphs.applies``), on the CPU: which archs and runtime states
take graphs (a card, no mesh, the sanitizer off, attention blocks only, a
dense FFN, a vocabulary that fills its padded width, the kernel's route),
and that an engine on the CPU never captures nor replays. The graphs
themselves run on the card (``tests/test_torch_gpu.py``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serving import Engine, SamplingParams, ServeConfig  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402

CUDA = torch.device("cuda")    # a device name: no card is needed to ask

# (config, takes graphs at full width, reduced): the reduced vocabulary
# (512) fills its padded width, qwen2's and stablelm's full ones do not
RULE = [
    ("paper-cim-120m", True, True),
    ("gemma3-1b", True, True),          # global and local rings
    ("granite-8b", True, True),
    ("chameleon-34b", True, True),
    ("musicgen-medium", True, True),    # the engine refuses its embeddings
    ("qwen2-1.5b", False, True),        # 151 936 pads to 152 064
    ("stablelm-3b", False, True),       # 50 304 pads to 50 432
    ("mamba2-1.3b", False, False),      # SSM blocks
    ("recurrentgemma-9b", False, False),  # RG-LRU blocks
    ("grok-1-314b", False, False),      # MoE
    ("arctic-480b", False, False),      # MoE
]


@pytest.mark.parametrize("name, full, reduced", RULE)
def test_which_engines_take_graphs(name, full, reduced, monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    arch = get_config(name)
    assert graphs.applies(arch, CUDA) is full
    assert graphs.applies(arch.reduced(), CUDA) is reduced
    for a in (arch, arch.reduced()):
        assert not graphs.applies(a, "cpu")
        assert not graphs.applies(a.replace(
            cim=a.cim.with_backend("ref")), CUDA)
        with sharding.use_mesh(object()):        # any active mesh
            assert not graphs.applies(a, CUDA)
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        assert not graphs.applies(a, CUDA)
        monkeypatch.setenv("REPRO_SANITIZE", "0")
        assert graphs.applies(a, CUDA) is (full if a is arch else reduced)


@pytest.mark.parametrize("name", ["paper-cim-120m", "gemma3-1b",
                                  "mamba2-1.3b"])
def test_an_engine_on_the_cpu_never_captures(name):
    arch = get_config(name).reduced()
    eng = Engine(arch, init_params(arch, seed=0, device="cpu"),
                 ServeConfig(batch_slots=2, max_ctx=32), device="cpu")
    eng.add_request([3, 1, 4, 1, 5, 9, 2, 6, 5])
    eng.add_request([2, 7], params=SamplingParams(max_tokens=2))
    for _ in range(3):
        eng.step()
    assert eng.stats["decode_steps"] == 3
    assert eng.stats["prefill_dispatches"] == 2
    assert eng.graph_stats == {"captures": 0, "replays": 0}
    assert eng._graphs == {}
