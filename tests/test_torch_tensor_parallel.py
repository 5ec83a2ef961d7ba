"""The pieces of the port's split program (``parallel.sharding``'s SPMD
program over "model") in one process, without a process group, on
chunks: each rank is a thread, and an all-reduce is the chunks' values
met at a barrier and reduced.

* ``models.transformer.split_argmax`` over a vocabulary split into 4
  chunks equals ``torch.argmax`` on the whole rows, ties included (within
  a chunk, across chunk edges, and whole rows of one value): the first
  occurrence wins, as it does in ``prefill_step`` without a mesh.
* Decode attention over a KV context split into chunks
  (``layers.softmax_partial`` per chunk, ``layers.merge_partials`` over
  them, through the two all-reduces) is within rtol 2e-4 of
  the softmax over the gathered context (the reference's sharded-vs-
  unsharded rtol, ``tests/test_dryrun.py``), chunks whose every key is
  masked included.
* The loss's log-sum-exp by vocabulary blocks (``transformer._nll``) is
  the log-softmax cross-entropy within 1e-6.
* A packed weight's "model" chunk (``sharding.split_model``, rank 0 of a
  4-wide "model" axis on the ``fake`` group) holds the whole weight's
  codes of its columns and keeps the whole weight's scale.
"""
import math
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

RTOL = 2e-4
NM = 4


class Threads:
    """``n`` ranks as threads: ``reduce(rank, t, op)`` meets every rank's
    ``t`` and returns ``op`` of them stacked (an all-reduce)."""

    def __init__(self, n: int):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n)

    def reduce(self, rank: int, t: torch.Tensor, op) -> torch.Tensor:
        self.slots[rank] = t
        self.barrier.wait()
        out = op(torch.stack(self.slots))
        self.barrier.wait()
        return out

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank at once; their results in rank
        order."""
        out = [None] * self.n
        errors = []

        def one(r):
            try:
                out[r] = fn(r)
            except BaseException as e:      # noqa: BLE001
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _max(s):
    return s.amax(0)


def _sum(s):
    return s.sum(0)


def test_split_argmax_equals_argmax_ties_included():
    rng = np.random.default_rng(0)
    v = 64
    # few distinct values: ties inside chunks and across chunk edges
    logits = torch.tensor(rng.integers(0, 5, (6, 7, v)), dtype=torch.float32)
    logits[0, 0] = 3.0                       # one value everywhere
    logits[1, 1, :] = 0.0
    logits[1, 1, v // NM - 1] = 9.0          # the last column of chunk 0
    logits[1, 1, v // NM] = 9.0              # the first of chunk 1
    logits[2, 2, :] = -1.0
    logits[2, 2, 3 * v // NM + 2] = 7.0      # a max in the last chunk only
    chunks = logits.chunk(NM, dim=-1)
    g = Threads(NM)
    got = g.run(lambda r: T.split_argmax(
        chunks[r], r * (v // NM), lambda t: g.reduce(r, t, _max)))
    want = torch.argmax(logits, dim=-1)
    for ids in got:                          # every rank the same ids
        assert torch.equal(ids, want)
    assert int(want[0, 0]) == 0 and int(want[1, 1]) == v // NM - 1
    assert int(want[2, 2]) == 3 * v // NM + 2


def _attention_case(seed, b=3, kv=2, g=2, t=64, d=16):
    """Scores (B, KV, G, 1, T) masked at ``layers._NEG_INF`` past each
    lane's position (lane 0 sees only the first chunk's keys) and values
    (B, T, KV, D)."""
    gen = torch.Generator().manual_seed(seed)
    scores = torch.randn((b, kv, g, 1, t), generator=gen) * 4
    vals = torch.randn((b, t, kv, d), generator=gen)
    pos = torch.tensor([t // NM - 3, t // 2 + 1, t - 1])
    valid = torch.arange(t)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, L._NEG_INF)
    return scores, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_split_softmax_matches_gathered(seed):
    scores, vals = _attention_case(seed)
    want = torch.einsum("bkgst,btkd->bskgd", torch.softmax(scores, dim=-1),
                        vals)
    s_chunks = scores.chunk(NM, dim=-1)
    v_chunks = vals.chunk(NM, dim=1)
    g = Threads(NM)

    def rank(r):
        m, l, o = L.softmax_partial(s_chunks[r], v_chunks[r], torch.float32)
        return L.merge_partials(m, l, o, lambda t: g.reduce(r, t, _max),
                                lambda t: g.reduce(r, t, _sum))

    outs = g.run(rank)
    scale = float(want.abs().max())
    for got in outs:
        assert got.shape == want.shape
        # lane 0's later chunks hold no valid key: they weigh nothing
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= RTOL * scale


def test_loss_by_vocabulary_blocks_is_the_cross_entropy():
    cfg = get_config("qwen2-1.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 5, cfg.padded_vocab), generator=gen) * 3
    labels = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    got = T._nll(logits, labels, cfg)
    want = -torch.gather(torch.log_softmax(logits, dim=-1), -1,
                         labels[..., None])[..., 0]
    assert T.LSE_BLOCKS % math.gcd(cfg.padded_vocab, T.LSE_BLOCKS) == 0
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_packed_weight_chunk_keeps_the_whole_scale():
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.formats import FP4_E2M1
    from repro_torch.kernels.packed import pack_weight, unpack_weight
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.parallel import sharding

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((96, 64), generator=gen)
    w[5, 60] = 9.0                 # the absmax lies outside rank 0's chunk
    pw = pack_weight(w, FP4_E2M1, 32)
    with fake_world(NM):
        mesh = DeviceMesh("cpu", torch.arange(NM).reshape(1, NM),
                          mesh_dim_names=("data", "model"))
        with sharding.use_mesh(mesh), sharding.spmd():
            assert sharding.splits(64) and sharding.model_rank() == 0
            part = sharding.split_model(pw)
            assert sharding.split_model(pw) is part        # made once
            halves = sharding.split_model(pw, groups=2)
    assert (part.n, part.k) == (64 // NM, 96) and part.sw == pw.sw
    full = unpack_weight(pw)
    assert torch.equal(unpack_weight(part), full[:, :64 // NM])
    # two column groups: the first columns of each half
    assert torch.equal(unpack_weight(halves), torch.cat(
        [full[:, :8], full[:, 32:40]], dim=1))
