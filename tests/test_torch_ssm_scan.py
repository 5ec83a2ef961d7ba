"""The SSM block's choice between the card's scan (``kernels.ssm_scan``)
and its per-step loop, on the CPU: CPU and ``meta`` tensors take the loop
and never load the kernel library; the scan's entry refuses a width, a
dtype or a device it cannot take, with a message; the choice is by device
alone, whatever the CIM backend; and the block's arguments reach the
scan's entry in its order (a stand-in that runs the loop behind the
entry's own checks gives the loop's results bit for bit).

The kernel itself runs only on the card: ``tests/test_torch_gpu.py``
holds it to the loop there.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssm_scan as scan  # noqa: E402
from repro_torch.models import init_params, to_device  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

B, S = 4, 8
# the module: the package's ``grmac_matmul`` is the dispatching function
grmac_matmul = sys.modules["repro_torch.kernels.grmac_matmul"]


def _no_library(*args, **kwargs):
    raise AssertionError("the kernel library was asked for")


@pytest.fixture(scope="module")
def block():
    arch = get_config("mamba2-1.3b").reduced()
    return arch, init_params(arch, seed=0, device="cpu")["layers"][0]["ssm"]


def _inputs(arch, device):
    gen = torch.Generator().manual_seed(3)
    u = torch.randn((B, S, arch.d_model), generator=gen)
    state = {"h": torch.randn((B, arch.ssm_heads, arch.ssm_state,
                               arch.ssm_headdim), generator=gen),
             "conv": torch.randn((B, arch.conv_width - 1, arch.d_inner),
                                 generator=gen)}
    length = torch.tensor([S, 1, 0, S - 3])
    return (u.to(device), {k: t.to(device) for k, t in state.items()},
            length.to(device))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_loop_without_the_library(block, device,
                                                         monkeypatch):
    monkeypatch.setattr(grmac_matmul, "build", _no_library)
    monkeypatch.setattr(scan, "ssm_scan", _no_library)
    arch, p = block
    p = to_device(p, device)
    u, state, length = _inputs(arch, device)
    steps = []
    real = ssm._recurrence_step

    def counted(*args):
        steps.append(1)
        return real(*args)

    monkeypatch.setattr(ssm, "_recurrence_step", counted)
    out, new = ssm.ssm_prefill(p, u, arch, state, length)
    assert out.shape == (B, S, arch.d_model) and len(steps) == S
    out, new = ssm.ssm_decode(p, u[:, :1], arch, new)
    assert out.shape == (B, 1, arch.d_model) and len(steps) == S + 1
    assert new["h"].shape == state["h"].shape
    assert new["conv"].shape == state["conv"].shape
    assert not scan.applies(device)


def _operands(arch, **change):
    """The scan's operands at the reduced widths on the CPU, with any of
    them replaced."""
    nh, n, hd, w = (arch.ssm_heads, arch.ssm_state, arch.ssm_headdim,
                    arch.conv_width)
    ops = dict(x=torch.zeros((B, S, nh * hd)), bmat=torch.zeros((B, S, n)),
               cmat=torch.zeros((B, S, n)), dt=torch.zeros((B, S, nh)),
               rate=torch.ones((1, nh)), d_skip=torch.ones((nh,)),
               kernel=torch.zeros((w, nh * hd)),
               h=torch.zeros((B, nh, n, hd)),
               win=torch.zeros((B, w - 1, nh * hd)),
               length=torch.full((B,), S))
    ops.update(change)
    return ops


@pytest.mark.parametrize("case, error, match", [
    ("state_width", ValueError, "no instance for ssm_state 64"),
    ("headdim", ValueError, "no instance for ssm_state 16, ssm_headdim 48"),
    ("conv_width", ValueError, "conv_width 3"),
    ("shape", ValueError, "dt has shape"),
    ("x_dtype", TypeError, "x in float32 or bfloat16, got torch.float16"),
    ("state_dtype", TypeError, "h in float32, got torch.float64"),
    ("length_dtype", TypeError, "length in int32 or int64"),
    ("cpu", ValueError, "one CUDA device"),
    ("meta", ValueError, "one CUDA device"),
])
def test_scan_entry_refuses_what_it_cannot_take(block, case, error, match,
                                                monkeypatch):
    monkeypatch.setattr(grmac_matmul, "build", _no_library)
    arch = block[0]
    nh, n, hd = arch.ssm_heads, arch.ssm_state, arch.ssm_headdim
    change = {
        "state_width": dict(h=torch.zeros((B, nh, 64, hd)),
                            bmat=torch.zeros((B, S, 64)),
                            cmat=torch.zeros((B, S, 64))),
        "headdim": dict(h=torch.zeros((B, nh, n, 48))),
        "conv_width": dict(kernel=torch.zeros((3, nh * hd))),
        "shape": dict(dt=torch.zeros((B, S, nh + 1))),
        "x_dtype": dict(x=torch.zeros((B, S, nh * hd),
                                      dtype=torch.float16)),
        "state_dtype": dict(h=torch.zeros((B, nh, n, hd),
                                          dtype=torch.float64)),
        "length_dtype": dict(length=torch.full((B,), float(S))),
        "cpu": {},
    }
    ops = (_operands(arch) if case != "meta" else
           {k: t.to("meta") for k, t in _operands(arch).items()})
    ops.update(change.get(case, {}))
    with pytest.raises(error, match=match):
        scan.ssm_scan(**ops)


def test_applies_reads_the_device_alone():
    assert scan.applies("cuda") and scan.applies(torch.device("cuda", 1))
    assert not scan.applies("cpu") and not scan.applies("meta")


def test_every_backend_reaches_the_scan_with_the_loops_results(
        block, monkeypatch):
    """With the device taken for a card (``applies`` true), prefill and
    decode call the scan's entry once each under every CIM backend, and a
    stand-in behind the entry's own checks (which refuse only the CPU
    device) that runs the loop on its operands gives the loop's outputs
    and states bit for bit."""
    monkeypatch.setattr(grmac_matmul, "build", _no_library)
    arch0, p = block
    u, state, length = _inputs(arch0, "cpu")
    real_entry = scan.ssm_scan
    for name, arch in (("plain", arch0),
                       ("grmac", arch0.replace(
                           cim=arch0.cim.with_mode("grmac"))),
                       ("ref", arch0.replace(
                           cim=arch0.cim.with_mode("grmac")
                           .with_backend("ref")))):
        monkeypatch.setattr(scan, "applies", lambda device: False)
        want = [ssm.ssm_prefill(p, u, arch, state, length)]
        want.append(ssm.ssm_decode(p, u[:, :1], arch, want[0][1]))
        calls = []

        def stand_in(x, bmat, cmat, dt, rate, d_skip, kernel, h, win,
                     length=None):
            with pytest.raises(ValueError, match="one CUDA device"):
                real_entry(x, bmat, cmat, dt, rate, d_skip, kernel, h, win,
                           length)
            calls.append(x.shape[1])
            if length is None:
                length = torch.full((x.shape[0],), x.shape[1])
            return ssm._loop(d_skip, arch.ssm_headdim, kernel, rate, h, win,
                             x, bmat, cmat, dt, length)

        monkeypatch.setattr(scan, "applies", lambda device: True)
        monkeypatch.setattr(scan, "ssm_scan", stand_in)
        got = [ssm.ssm_prefill(p, u, arch, state, length)]
        got.append(ssm.ssm_decode(p, u[:, :1], arch, got[0][1]))
        monkeypatch.setattr(scan, "ssm_scan", real_entry)
        assert calls == [S, 1], name
        for (out_g, st_g), (out_w, st_w) in zip(got, want):
            assert torch.equal(out_g, out_w), name
            for k in ("h", "conv"):
                assert torch.equal(st_g[k], st_w[k]), (name, k)
        # the frozen lane keeps its state bit for bit
        for k in ("h", "conv"):
            assert torch.equal(got[0][1][k][2], state[k][2]), (name, k)
