"""The port's roofline counter (``repro_torch.launch.roofline``): the
``TraceCounter`` dispatch mode over ``meta`` traces, held to hand counts
and to the JAX package's jaxprs. Every comparison is exact (tolerance 0)
unless it says otherwise.

* Collectives on an 8-rank ``fake`` mesh (2 x 4, no data moved): one
  ``gather_full`` of a parameter split over "data" counts its full bytes
  as an all-gather; one ``all_reduce_sum`` over the batch axes counts
  twice its bytes (the ring's reduce-scatter + all-gather); one ``chunk``
  moves nothing and one ``all_gather`` over "model" counts the gathered
  bytes as a collective and none as memory traffic.
* Memory: a view shares its base's storage and is counted once; a tensor
  autograd saves stays live until its backward frees it.
* Flops with the CIM path off, unsharded, on the reduced qwen2 / mamba2 /
  grok configs (attention unchunked, the reference's layers unrolled):
  the no-cache forward's and one decode step's flops equal the sum over
  the reference jaxpr's ``dot_general``s that contract a dimension. The
  reference also lowers the SSD's outer products (einsums with no
  contracted dimension) to ``dot_general``; the port computes those as
  elementwise products, in XLA's order (``models/ssm.py``), which no
  matmul counter sees: mamba2's jaxprs hold such products, the others
  none.
* A CIM trace: the projections' flops are 2 x the cost ledger's MACs,
  whose entries equal ``costs.trace_decode``'s (decode) and
  ``trace_train``'s (the no-cache forward) entry by entry, and the
  GR-MAC trace's total equals the CIM-off trace's; a train step under
  remat counts the forward's projections and every recomputed one.
* Bytes: one ``cim_matmul`` on ``meta`` counts its x, weight and output
  once; the CIM projections of reduced qwen2's decode and prefill count,
  by hand over the params tree, every projection weight once (the
  weight stream) beside its (M, K) input and (M, N) output.
* Per-device flops x 8 on an 8 x 1 mesh equal the unsharded flops.
* ``RooflineReport.row()`` equals the reference's on the same inputs,
  with the reference's peak swapped for the H100's.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.extend.core as jcore  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.core import costs  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs  # noqa: E402
from repro_torch.launch.mesh import HW  # noqa: E402
from repro_torch.models import decode_step, forward  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

META = torch.device("meta")
B, S, CTX = 2, 64, 64


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


# ------------------------------------------------------------ collectives
def test_collective_bytes_hand_counted():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_world(8):
        mesh = _mesh((2, 4))
        w = distribute_tensor(torch.empty((64, 32), device=META), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        counter = roofline.TraceCounter()
        with counter:
            full = sharding.gather_full(w)
        assert tuple(full.shape) == (64, 32)
        assert counter.collectives == {"all-gather": 64 * 32 * 4}

        counter = roofline.TraceCounter()
        with sharding.use_mesh(mesh), sharding.spmd(), counter:
            sharding.all_reduce_sum(torch.empty((10,), device=META))
        assert counter.collectives == {"all-reduce": 2 * 10 * 4}

        counter = roofline.TraceCounter()
        with sharding.use_mesh(mesh), sharding.spmd(), counter:
            part = sharding.chunk(torch.empty((8, 3), device=META), 0)
            assert counter.collectives == {}
            assert tuple(part.shape) == (2, 3)
            whole = sharding.all_gather(part, 0)
        assert tuple(whole.shape) == (8, 3)
        assert counter.collectives == {"all-gather": 8 * 3 * 4}
        # gathered into one tensor along dim 0: no copy or concatenation
        # moves bytes beside the collective's own
        assert counter.bytes == 0 and counter.flops == 0


# ----------------------------------------------------------------- memory
def test_memory_counts_a_view_once_and_saved_tensors_until_backward():
    counter = roofline.TraceCounter()
    x = torch.empty((256, 256), device=META)
    counter.watch((x,))
    with counter:
        y = x * 2.0
        v = y[1:]
        w = y.view(-1)
        assert counter.live == 2 * 256 * 256 * 4   # x and y, once each
        del v, w, y
        assert counter.live == 256 * 256 * 4
    mem = counter.memory(x)
    assert mem == {"arguments": 256 * 256 * 4, "outputs": 256 * 256 * 4,
                   "temps": 256 * 256 * 4, "aliased": 256 * 256 * 4,
                   "peak_est": 2 * 256 * 256 * 4}

    counter = roofline.TraceCounter()
    a = torch.empty((128, 128), device=META, requires_grad=True)
    counter.watch((a,))
    n = 128 * 128 * 4
    with counter:
        h = torch.sin(a)          # sin saves its input: a, an argument
        g = torch.exp(h)          # exp saves its output g
        out = g.sum()
        del h
        # h is freed (exp saved its output, not h); g is held by autograd
        assert counter.live == n + n + 4
        del g
        assert counter.live == n + n + 4          # still saved for backward
        out.backward()
        del out
        assert counter.live == n + n              # a and its grad
    assert counter.peak >= 3 * n


# ------------------------------------------------------------------ flops
def _dot_flops(jaxpr, mult: int = 1, contracting_only: bool = True) -> int:
    """2 x out elements x contracted size over every ``dot_general``
    (scan bodies times their length); ``contracting_only`` skips those
    that contract no dimension (outer products)."""
    total = 0
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            if lc or not contracting_only:
                lhs = e.invars[0].aval.shape
                total += mult * 2 * math.prod(e.outvars[0].aval.shape) \
                    * math.prod(lhs[d] for d in lc)
        m = mult * (e.params.get("length", 1)
                    if e.primitive.name == "scan" else 1)
        for v in e.params.values():
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, jcore.ClosedJaxpr):
                    total += _dot_flops(x.jaxpr, m, contracting_only)
                elif isinstance(x, jcore.Jaxpr):
                    total += _dot_flops(x, m, contracting_only)
    return total


def _jax_flops(name, phase):
    arch = jax_get_config(name).reduced()
    arch = arch.replace(scan_layers=False, attn_chunk=None,
                        cim=arch.cim.with_mode("off"))
    params = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                    arch))
    if phase == "prefill":
        x = jax.ShapeDtypeStruct((B, S), jnp.int32)
        jaxpr = jax.make_jaxpr(lambda p, t: jax_forward(p, t, arch)[0])(
            params, x).jaxpr
    else:
        cache = jax.eval_shape(lambda: jax_init_cache(arch, B, CTX,
                                                      jnp.float32))
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        jaxpr = jax.make_jaxpr(lambda p, t, c: jax_decode_step(
            p, t, arch, c, jnp.int32(5))[0])(params, tok, cache).jaxpr
    return _dot_flops(jaxpr), _dot_flops(jaxpr, contracting_only=False)


def _torch_trace(arch, phase, batch=B):
    """(counter, ledger) of one unsharded ``meta`` trace."""
    params = init_params(arch, 0, device=META)
    if phase == "prefill":
        fn = lambda p, t: forward(p, t, arch)[0]  # noqa: E731
        args = (params, torch.empty((batch, S), dtype=torch.int32,
                                    device=META))
    else:
        fn = lambda p, t, c: decode_step(p, t, arch, c, 5)[0]  # noqa: E731
        args = (params, torch.empty((batch, 1), dtype=torch.int32,
                                    device=META),
                init_cache(arch, batch, CTX, torch.float32, META))
    counter, ledger = roofline.TraceCounter(), costs.CostLedger()
    with torch.no_grad(), costs.recording(ledger), counter:
        fn(*args)
    return counter, ledger


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-1.3b",
                                  "grok-1-314b"])
def test_cim_off_flops_equal_reference_dot_generals(name, phase):
    arch = torch_get_config(name).reduced()
    arch = arch.replace(attn_chunk=None, cim=arch.cim.with_mode("off"))
    counter, ledger = _torch_trace(arch, phase)
    got = counter.flops + counter.cim_flops
    # the short-circuited projections are the ledger's entries, the MoE
    # experts apart (their batched matmuls are counted as ops)
    assert counter.cim_flops == 2 * (ledger.macs()
                                     - ledger.macs("moe_expert"))
    contracting, every = _jax_flops(name, phase)
    assert got == contracting
    # outer products only in mamba2's SSD
    assert (every > contracting) == (name == "mamba2-1.3b")


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_cim_trace_adds_exactly_the_ledger_ops(phase):
    arch = torch_get_config("paper-cim-120m").reduced()
    assert arch.cim.mode == "grmac"
    counter, ledger = _torch_trace(arch, phase)
    # the energy ledger's own traces: one decode step; the no-cache
    # forward is its train trace
    want = (costs.trace_decode(arch, batch=B, ctx=CTX) if phase == "decode"
            else costs.trace_train(arch, batch=B, seq_len=S))
    assert ledger.entries() == want.entries()
    assert counter.cim_flops == 2 * ledger.macs()
    off = arch.replace(cim=arch.cim.with_mode("off"))
    c_off, l_off = _torch_trace(off, phase)
    assert counter.flops == c_off.flops
    assert counter.cim_flops == c_off.cim_flops == 2 * l_off.macs()
    assert counter.bytes == c_off.bytes


def test_train_trace_counts_every_recomputed_projection():
    # remat's recomputation stops once the backward has what it needs,
    # inside the last projection of a super-block, which the card has
    # launched by then: the counter and the ledger both count it
    arch = torch_get_config("paper-cim-120m").reduced().replace(remat=True)
    case = specs.ShapeCase("train", S, B, "train")
    with dryrun.fake_world(1):
        cell = specs.make_cell(arch, case, _mesh((1, 1)))
        counter, ledger = roofline.TraceCounter(), costs.CostLedger()
        with costs.recording(ledger), counter:
            cell.fn(*cell.args)
    fwd = costs.trace_train(arch, batch=B, seq_len=S)
    assert ledger.macs() == 2 * fwd.macs() - fwd.macs("head")
    assert counter.cim_flops == 2 * ledger.macs()


# ------------------------------------------------------------------ bytes
def test_one_cim_call_counts_its_operands_once():
    from repro_torch.core.cim_config import CIMConfig
    from repro_torch.kernels.ops import cim_matmul

    x = torch.empty((3, 5, 16), dtype=torch.bfloat16, device=META)
    w = torch.empty((16, 24), device=META)
    for cfg in (None, CIMConfig(mode="grmac")):
        counter = roofline.TraceCounter()
        with counter:
            out = cim_matmul(x, w, cfg, site="mlp_in")
        assert tuple(out.shape) == (3, 5, 24)
        assert counter.cim_flops == 2 * 15 * 16 * 24
        assert counter.cim_bytes == 15 * 16 * 2 + 16 * 24 * 4 + 15 * 24 * 2
        assert counter.bytes == counter.cim_bytes and counter.flops == 0


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_cim_off_bytes_hold_every_projection_weight(phase):
    from repro_torch.tree import tree_paths

    arch = torch_get_config("qwen2-1.5b").reduced()
    arch = arch.replace(attn_chunk=None, cim=arch.cim.with_mode("off"))
    assert arch.dtype == "float32"
    counter, _ = _torch_trace(arch, phase)
    m = B * (S if phase == "prefill" else 1)
    # every 2-D "w" leaf is one projection (K, N), run once on M rows
    weights = [tuple(t.shape) for path, t in tree_paths(
        init_params(arch, 0, device=META)) if path.endswith("/w")]
    assert len(weights) == 7 * arch.n_layers + 1        # and the head
    hand = sum(4 * (k * n + m * k + m * n) for k, n in weights)
    assert counter.cim_bytes == hand
    assert counter.bytes > hand


@pytest.mark.parametrize("shape", ["prefill", "decode"])
def test_per_device_flops_times_8_equal_unsharded(shape):
    arch = torch_get_config("qwen2-1.5b").reduced()
    case = specs.ShapeCase(shape, CTX if shape == "decode" else S, 8, shape)
    counter, _ = _torch_trace(arch, shape, batch=8)
    unsharded = counter.flops + counter.cim_flops
    with dryrun.fake_world(8):
        cell = specs.make_cell(arch, case, _mesh((8, 1)))
        _, _, cost = roofline.roofline_from_trace(
            arch.name, shape, "8x1", 8, cell.fn, cell.args, arch, case)
    assert cost["flops_per_device"] * 8 == unsharded


def test_report_row_matches_reference(monkeypatch):
    monkeypatch.setattr(jroof.HW, "PEAK_FLOPS_BF16", HW.PEAK_FLOPS_BF16)
    kw = dict(arch="qwen2-1.5b", shape="train_4k", mesh="16x16", chips=256,
              flops_per_device=3.1e15, bytes_per_device=2.2e12,
              coll_bytes_per_device=4.5e10,
              coll_breakdown={"all-gather": 4.5e10},
              t_compute=3.1e15 / HW.PEAK_FLOPS_BF16,
              t_memory=2.2e12 / HW.HBM_BW, t_collective=4.5e10 / HW.NVLINK_BW,
              model_flops=6.0e17, peak_util_bound=0.5)
    ours, ref = roofline.RooflineReport(**kw), jroof.RooflineReport(**kw)
    assert ours.row() == ref.row()
    assert ours.dominant == ref.dominant == "compute"
    for t in ("t_memory", "t_collective"):
        kw2 = dict(kw, **{t: 1.0})
        assert roofline.RooflineReport(**kw2).row() == \
            jroof.RooflineReport(**kw2).row()
