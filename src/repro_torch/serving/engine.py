"""Batched serving engine: slot-based continuous batching over a fixed-size
decode batch with chunked, length-bucketed prefill and per-lane sampling.

The port's counterpart of ``repro.serving.engine``; it replays exactly the
reference's batches, because the CIM pre-scale couples the lanes of a
dispatch (one absmax over the whole activation): every prefill chunk and
every decode step runs all ``batch_slots`` lanes, with the same bucket
padding and the same frozen lanes.

Prefill pads each prompt chunk to a power-of-two bucket and runs it through
``models.prefill_step``: one dispatch per chunk; the other lanes ride along
with length 0 and their caches come back unchanged. The first output
token is selected from the prefill itself (the last valid token's
logits), so the first decode step feeds the first *generated* token. The
legacy ``prefill_mode="token"`` path (one decode dispatch per prompt
token) is the equivalence oracle.

Decode (``step``) runs the whole batch; lanes that are not active compute
like the others and keep their caches (the reference's per-lane merge,
done here by restoring the one KV or ring row a decode writes, and the
whole lane of an RG-LRU or SSM state and conv window). Token selection
stays on the device: greedy argmax, or, when some active lane samples,
``serving.sampling.select`` over the whole batch (lanes at temperature 0
take the argmax there too). The host sees exactly one device→host
transfer per step, a ``(batch_slots,)`` int32 array of ids, and one per
first-token selection, all through ``_fetch``.

Sampling contract (the reference's): a lane samples iff its temperature
is above 0 and it has entropy, the caller's ``key`` (a
``serving.sampling`` key, a Python int) or its own
``SamplingParams.seed``. ``add_request`` / ``finish_prefill`` with a
positive temperature, no key and no seed warn (``UserWarning``) and take
the argmax; ``step`` applies the same rule silently. A seeded lane draws
from ``fold_in(key(seed), event)``, whatever its slot, the caller's key
or the other traffic.

Incremental prefill: ``begin_request`` claims a slot, ``advance_prefill``
runs one bucketed chunk, ``finish_prefill`` selects the first token and
activates the lane; ``add_request`` is their blocking composition.
``release_slot`` frees a lane; ``free_slots`` counts claimable ones.

Prefix cache (``serving.prefix_cache``): with
``ServeConfig.prefix_cache_bytes`` set (or a ``PrefixCache`` passed in),
``begin_request`` copies the longest cached prefix into the claimed lane
and queues only the suffix, and ``advance_prefill`` ends chunks on cache
boundaries and stores a copy of the lane at each; nothing crosses to the
host.

Weights: the engine packs every CIM site's weight once at construction
(``models.pack_params``: the per-call pre-scale and quantization of the
reference done once, stored as 4-bit or 8-bit format codes), so a
dispatch re-quantizes no weight. ``cim_backend="ref"`` keeps the raw
weights and the per-call path: it is the independent oracle.

It serves every block kind of the port: global and sliding-window
attention (ring caches of ``min(window, max_ctx)`` slots), RG-LRU and
Mamba2 SSD blocks (f32 recurrent states, whatever ``cache_dtype`` says),
with dense or MoE FFNs. An MoE decode routes every lane, the inactive
ones too (they feed their last token, as the reference's engine does),
so they take expert capacity there as in the reference. Models on
embedding inputs are served through ``models.prefill_step`` /
``decode_step``, not here: the engine refuses them, as the reference's
does.

Energy: ``energy_report`` prices the ``core.costs`` ledgers of a
shape-only (``meta``) run of the model functions per site, and
``Engine.energy_per_token`` prices one decode step's ledger at batch 1,
once per engine; ``StepResult.pj_per_token`` and
``RequestOutput.pj_per_token`` read it lazily, so a caller that does not
read them pays no trace and no Monte-Carlo solve. The solve draws on the
engine's device. The ledger traces its own ``meta`` tree, never the
served (packed) weights.

Speculative seams (``serving.speculative`` orchestrates them and holds
the design note): ``spec_snapshot`` clones the rollback-sensitive cache
tensors (local-attention rings, RG-LRU / SSM states and conv windows; the
port's caches change in place, so a reference would not do) and
``spec_restore`` copies them back into the chosen lanes only; global KV
needs none, since rows past a lane's length stay masked until they are
overwritten. ``draft_step`` is one greedy decode dispatch of a draft
arch (same weights, shared cache; a draft arch other than the served one
gets its own params from the raw weights, prepared once and kept);
``verify_chunk`` scores a chunk through ``prefill_step``'s per-position
ids; ``verify_chunk_sampled`` runs the rejection rule on the device,
drawing from ``serving.sampling`` keys, with one packed fetch;
``repair_chunk`` re-feeds accepted prefixes and fetches nothing.

Dispatch seam: every model dispatch goes through ``_dispatch(key, fn,
*args)``, named as the reference's executables are keyed
(``decode[sample=…]``: a decode step with its token selection, also the
"self" drafter's and a token-mode prefill's; ``draft[sample=False]``
another draft arch's; ``prefill[bucket=…]``: a prefill chunk, a greedy
verify and a repair; ``verify[bucket=…]``: a sampled verify), and every
device→host transfer through ``_fetch``. Both are plain calls here, each
in a scope of its own (``core.scopes``: ``engine.<key>``,
``engine.fetch``); ``analysis.invariants.InstrumentedEngine`` counts at
them.

CUDA graphs (``serving.graphs``): where ``graphs.applies`` (a card, no
mesh, the sanitizer off, attention blocks only, a dense FFN, a vocabulary
that fills its padded width, the kernel's route), the engine captures at construction the served arch's decode
forward and its ``prefill_step`` at every bucket a prompt under
``max_ctx`` can need, and replays them inside the same dispatches (the
decode forward under ``decode[…]`` — the step's, the "self" drafter's, a
token-mode prefill's —, a chunk, a greedy verify and a repair under
``prefill[bucket=…]``; one key, one executable). Token selection and
``_fetch`` stay eager. Every other dispatch, and every dispatch while a
mesh is active or the sanitizer is on, runs eagerly as before.
``graph_stats["captures"]`` counts the captures, ``["replays"]`` the
replays.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costs
from repro_torch.core.device import require_full_f32, resolve_device
from repro_torch.core.scopes import named_scope
from repro_torch.models import (decode_step, forward, init_cache,
                                pack_params, prefill_step)
from repro_torch.serving import graphs, sampling
from repro_torch.serving.params import RequestOutput, SamplingParams
from repro_torch.serving.prefix_cache import (PrefixCache, restore_slot,
                                              snapshot_slot)

__all__ = ["ServeConfig", "Engine", "StepResult", "SamplingParams",
           "RequestOutput", "energy_report"]


class StepResult(dict):
    """``Engine.step`` result: slot id -> token emitted this step, plus
    ``finished`` — the slot ids freed this step (EOS, ``max_tokens``, or
    context exhaustion, and completions recorded at prefill time), in
    ascending slot order —, ``outputs``, a ``RequestOutput`` per live
    request, and ``pj_per_token``, the decode-phase CIM energy per
    generated token (None when the arch serves without the CIM path),
    resolved on first read through a thunk into
    ``Engine.energy_per_token``'s memo."""

    def __init__(self, tokens: dict, finished: List[int],
                 energy_fn: Optional[Callable[[], Optional[float]]] = None,
                 outputs: Optional[List[RequestOutput]] = None):
        super().__init__(tokens)
        self.finished = finished
        self.outputs: List[RequestOutput] = outputs if outputs is not None \
            else []
        self._energy_fn = energy_fn

    @property
    def pj_per_token(self) -> Optional[float]:
        return self._energy_fn() if self._energy_fn is not None else None


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_ctx: int = 2048
    temperature: float = 0.0
    cache_dtype: str = "float32"
    # GR-MAC backend override for CIM-enabled archs: None keeps the arch's
    # CIMConfig.backend; "ref" runs the plain version on the card too
    cim_backend: Optional[str] = None
    # Default EOS token id; None decodes every lane to max_ctx.
    eos_id: Optional[int] = None
    # "bucketed": chunked prefill, prompts padded to power-of-two buckets;
    # "token": one decode dispatch per prompt token (the equivalence oracle)
    prefill_mode: str = "bucketed"
    prefill_bucket_min: int = 8
    prefill_bucket_max: int = 1024
    # byte budget of the prefix cache (bucketed prefill only); None: off
    prefix_cache_bytes: Optional[int] = None


class Engine:
    def __init__(self, arch: ArchConfig, params, cfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None, *,
                 prefix_cache: Optional[PrefixCache] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_full_f32()
        if arch.input_mode != "tokens":
            raise ValueError("the engine serves token models")
        if cfg.prefill_mode not in ("bucketed", "token"):
            raise ValueError(f"unknown prefill_mode {cfg.prefill_mode!r}")
        # an explicit cache may be shared by engines; prefix_cache_bytes
        # builds a private one. Its chunk must be the smallest bucket, so
        # every stored boundary is a length the buckets serve
        if prefix_cache is None and cfg.prefix_cache_bytes is not None:
            prefix_cache = PrefixCache(cfg.prefix_cache_bytes,
                                       chunk_tokens=cfg.prefill_bucket_min)
        if prefix_cache is not None:
            if cfg.prefill_mode != "bucketed":
                raise ValueError(
                    "prefix cache requires prefill_mode='bucketed' (the "
                    "token path replays whole prompts)")
            if prefix_cache.chunk != cfg.prefill_bucket_min:
                raise ValueError(
                    f"prefix cache chunk {prefix_cache.chunk} != "
                    f"prefill_bucket_min {cfg.prefill_bucket_min}: cached "
                    "boundaries would not align with the buckets")
        self.prefix_cache = prefix_cache
        if cfg.cim_backend is not None:
            arch = arch.replace(cim=arch.cim.with_backend(cfg.cim_backend))
        self.arch = arch
        self.cfg = cfg
        # the raw weights stay referenced: a speculative draft arch other
        # than the served one prepares its own params from them
        self._raw_params = params
        self.params = self._prepared(params, arch)
        self._draft_params: Dict[ArchConfig, dict] = {arch: self.params}
        self.cache = init_cache(arch, cfg.batch_slots, cfg.max_ctx,
                                getattr(torch, cfg.cache_dtype), self.device)
        b = cfg.batch_slots
        self.lengths = np.zeros(b, np.int32)
        self.active = np.zeros(b, bool)
        self.tokens: List[List[int]] = [[] for _ in range(b)]
        # last emitted token per lane, fed back as the next decode input
        self._last_host = np.zeros(b, np.int32)
        # per-slot EOS id (-1: none), token cap (-1: none) and count emitted
        self._eos = np.full(b, -1, np.int64)
        self._max_toks = np.full(b, -1, np.int64)
        self._emitted = np.zeros(b, np.int64)
        # per-slot temperature, seed (-1: unseeded) and sampling-event
        # count, and speculative lookahead (-1: the decoder's default)
        self._temp = np.full(b, cfg.temperature, np.float32)
        self._seed = np.full(b, -1, np.int64)
        self._ctr = np.zeros(b, np.int64)
        self._spec_k = np.full(b, -1, np.int64)
        # prompt tokens the slot's occupant adopted from the prefix cache
        self._adopted = np.zeros(b, np.int64)
        self._finish_reason: List[Optional[str]] = [None] * b
        # slots that have hosted a request (zeroed before reuse)
        self._dirty = np.zeros(b, bool)
        # slots claimed by a request whose prefill has not finished yet
        self._prefilling = np.zeros(b, bool)
        self._pending_prompt: Dict[int, List[int]] = {}
        self._pending_logits: Dict[int, torch.Tensor] = {}
        # slots completed outside step() (first token == EOS, or a one-token
        # cap), surfaced through the next StepResult.finished
        self._pending_finished: List[int] = []
        # prefill_tokens counts the prompt tokens dispatched (the suffix
        # only, under a prefix hit)
        self.stats = {"prefill_dispatches": 0, "decode_steps": 0,
                      "prefill_tokens": 0, "prefix_hit_tokens": 0,
                      "draft_dispatches": 0, "verify_dispatches": 0,
                      "repair_dispatches": 0, "spec_steps": 0,
                      "spec_tokens": 0}
        # the decode-phase energy report, priced on first request
        self._energy: Optional[dict] = None
        # dispatch name ("decode", "prefill[bucket=…]") -> its CUDA graph,
        # and the cache tensors they were captured on; the port's own
        # counters of them, beside ``stats`` (which the reference's engine
        # keeps key for key)
        self._graphs: Dict[str, graphs.DispatchGraph] = {}
        self._graph_leaves: tuple = ()
        self.graph_stats = {"captures": 0, "replays": 0}
        if graphs.applies(arch, self.device):
            self._capture_graphs()

    @staticmethod
    def _prepared(params: dict, arch: ArchConfig) -> dict:
        """Served params of ``arch``: packed, except for the ``ref``
        backend, which keeps the raw weights and the per-call path (the
        independent oracle)."""
        return params if arch.cim.backend == "ref" else pack_params(params,
                                                                     arch)

    def _dispatch(self, key: str, fn: Callable, *args):
        """One model dispatch, ``fn(*args)``, named ``key`` (the seam the
        invariant harness counts at), in the scope ``engine.<key>``."""
        with named_scope(f"engine.{key}"):
            return fn(*args)

    # ------------------------------------------------------------ graphs
    def _capture_graphs(self) -> None:
        """Capture the served arch's decode forward and, under bucketed
        prefill, its ``prefill_step`` at every bucket from the least up to
        the one a chunk of ``min(prefill_bucket_max, max_ctx - 1)`` tokens
        takes, on inputs that freeze every lane; one memory pool."""
        b, dev = self.cfg.batch_slots, self.device
        index_dtype = torch.from_numpy(self.lengths).dtype
        pool = torch.cuda.graph_pool_handle()

        def decode(toks, index, active):
            return decode_step(self.params, toks, self.arch, self.cache,
                               index, active=active)[:1]

        def prefill(toks, index, lens):
            return prefill_step(self.params, toks, self.arch, self.cache,
                                index, lens)[:2]

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._graphs["decode"] = graphs.DispatchGraph(
            decode, (zeros(b, 1), zeros(b, dtype=index_dtype),
                     zeros(b, dtype=torch.bool)), pool)
        if self.cfg.prefill_mode == "bucketed":
            top = self._bucket(min(self.cfg.prefill_bucket_max,
                                   self.cfg.max_ctx - 1))
            bucket = self.cfg.prefill_bucket_min
            while bucket <= top:
                self._graphs[f"prefill[bucket={bucket}]"] = \
                    graphs.DispatchGraph(prefill, (
                        zeros(b, bucket), zeros(b, dtype=index_dtype),
                        zeros(b)), pool)
                bucket *= 2
        self._graph_leaves = graphs.cache_leaves(self.cache)
        self.graph_stats["captures"] = len(self._graphs)

    def _graph(self, name: str) -> Optional[graphs.DispatchGraph]:
        """The graph of dispatch ``name`` where the engine may replay it
        now (``graphs.replayable``), else None."""
        if self._graphs and graphs.replayable(self.cache,
                                              self._graph_leaves):
            return self._graphs.get(name)
        return None

    def _replay(self, graph: graphs.DispatchGraph, *host: np.ndarray):
        """Replay ``graph`` on the host arrays ``host``; its outputs."""
        self.graph_stats["replays"] += 1
        return graph(*host)

    def _snapshot(self, host_state: np.ndarray) -> torch.Tensor:
        """A device copy of mutable per-slot host state. ``torch.tensor``
        always copies (``from_numpy``/``as_tensor`` would alias a CPU
        array, which the engine mutates right after dispatching)."""
        with named_scope("engine.h2d"):
            return torch.tensor(host_state, device=self.device)

    # ------------------------------------------------------------ prefill
    def add_request(self, prompt: List[int], *, key: Optional[int] = None,
                    params: Optional[SamplingParams] = None) -> int:
        """Prefill a free slot, select the first output token from the
        prefill logits (sampled under the sampling contract: pass ``key``
        when the temperature is above 0 and the request has no seed), and
        return the slot id. A first token that hits the request's EOS (or
        a one-token cap) finishes the request at once; it is reported by
        the next ``step``."""
        slot = self.begin_request(prompt, params=params)
        if self.cfg.prefill_mode == "token":
            sample = self._resolve_sampling(key, slot)
            self._pending_prompt.pop(slot, None)
            for t in prompt[:-1]:
                self._advance_slot(slot, t)
            # the final dispatch's ids ARE the last-valid-token selection
            self._adopt_first_token(slot, self._advance_slot(
                slot, prompt[-1], sample=sample, key=key))
        else:
            while self.prefill_remaining(slot):
                self.advance_prefill(slot)
            self.finish_prefill(slot, key=key)
        return slot

    def begin_request(self, prompt: List[int], *,
                      params: Optional[SamplingParams] = None) -> int:
        """Claim and validate a free slot for ``prompt`` without running any
        prefill: the lane is reserved but not yet in the decode batch."""
        params = params if params is not None else SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.cfg.max_ctx:
            # the first decode step writes at position len(prompt), which
            # must still be a valid cache index
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs max_ctx > "
                f"{len(prompt)} (got {self.cfg.max_ctx}) to decode")
        free = np.where(~self.active & ~self._prefilling)[0]
        if len(free) == 0:
            raise RuntimeError("no free slots")
        slot = int(free[0])
        if self._dirty[slot]:
            self._reset_slot_state(slot)
        self._dirty[slot] = True
        self.tokens[slot] = list(prompt)
        self.lengths[slot] = 0
        self._prefilling[slot] = True
        self._pending_prompt[slot] = list(prompt)
        self._pending_logits.pop(slot, None)
        eos = params.eos_id if params.eos_id is not None else self.cfg.eos_id
        self._eos[slot] = -1 if eos is None else int(eos)
        self._max_toks[slot] = (-1 if params.max_tokens is None
                                else int(params.max_tokens))
        self._emitted[slot] = 0
        self._temp[slot] = (self.cfg.temperature
                            if params.temperature is None
                            else params.temperature)
        self._seed[slot] = -1 if params.seed is None else int(params.seed)
        self._ctr[slot] = 0
        self._spec_k[slot] = (-1 if params.spec_k is None
                              else int(params.spec_k))
        self._finish_reason[slot] = None
        self._adopted[slot] = 0
        if self.prefix_cache is not None:
            hit = self.prefix_cache.lookup(prompt)
            if hit is not None:
                # copy the cached prefix into the (zeroed) lane; only the
                # suffix is prefilled, from cache index p
                p, snap = hit
                restore_slot(self.cache, slot, p, snap)
                self.lengths[slot] = p
                self._pending_prompt[slot] = list(prompt[p:])
                self._adopted[slot] = p
                self.stats["prefix_hit_tokens"] += p
        return slot

    def prefill_remaining(self, slot: int) -> int:
        """Prompt tokens of ``slot`` not yet prefilled (0 once drained)."""
        return len(self._pending_prompt.get(slot, ()))

    def adopted_prefix(self, slot: int) -> int:
        """Prompt tokens the slot's occupant adopted from the prefix cache
        at ``begin_request`` (0: a cold prefill)."""
        return int(self._adopted[slot])

    def advance_prefill(self, slot: int,
                        max_tokens: Optional[int] = None) -> int:
        """One bucketed chunk dispatch for a mid-prefill slot: consumes
        ``min(remaining, prefill_bucket_max, max_tokens)`` prompt tokens and
        returns how many. The chunk's last-valid-token logits stay on the
        device for ``finish_prefill``."""
        rem = self._pending_prompt[slot]
        take = min(len(rem), self.cfg.prefill_bucket_max)
        if max_tokens is not None:
            take = min(take, int(max_tokens))
        if take <= 0:
            return 0
        pc = self.prefix_cache
        if pc is not None and take < len(rem):
            # a further chunk follows anyway: end this one on a cache
            # boundary (snapshots exist only there); it pads to a bucket
            # no larger than before
            aligned = take - (int(self.lengths[slot]) + take) % pc.chunk
            if aligned >= 1:
                take = aligned
        self._pending_logits[slot] = self._prefill_chunk(slot, rem[:take])
        del rem[:take]
        if pc is not None:
            done = int(self.lengths[slot])
            if done > 0 and done % pc.chunk == 0:
                # capture the boundary now (a recurrent state at an
                # interior length cannot be recovered later); insert()
                # skips the copy when the boundary is stored already
                pc.insert(self.tokens[slot][:done],
                          lambda: snapshot_slot(self.cache, slot, done,
                                                self.arch.blocks()))
        return take

    def finish_prefill(self, slot: int, key: Optional[int] = None) -> int:
        """Select the first output token from the final chunk's logits and
        activate the lane (or finish it at once). A positive temperature
        without ``key`` or seed warns and takes the argmax."""
        if self.prefill_remaining(slot):
            raise RuntimeError(
                f"slot {slot}: {self.prefill_remaining(slot)} prompt "
                "tokens still pending — drain with advance_prefill first")
        sample = self._resolve_sampling(key, slot)
        logits = self._pending_logits.pop(slot)
        del self._pending_prompt[slot]
        lane = np.zeros(self.cfg.batch_slots, bool)
        lane[slot] = True
        first = int(self._fetch(self._choose(logits, sample, key,
                                             lane))[slot])
        self._adopt_first_token(slot, first)
        return first

    def _adopt_first_token(self, slot: int, first: int) -> None:
        self.tokens[slot].append(first)
        self._last_host[slot] = first
        self._prefilling[slot] = False
        self._emitted[slot] = 1
        if self._eos[slot] >= 0 and first == self._eos[slot]:
            self.active[slot] = False
            self._finish_reason[slot] = "eos"
            self._pending_finished.append(slot)
        elif 0 <= self._max_toks[slot] <= 1:
            self.active[slot] = False
            self._finish_reason[slot] = "length"
            self._pending_finished.append(slot)
        else:
            self.active[slot] = True

    def finish_reason(self, slot: int) -> Optional[str]:
        """Terminal reason recorded when the engine froze the lane
        (``"eos"`` / ``"length"`` / ``"ctx"``); None while live or when the
        slot was freed externally (``release_slot``)."""
        return self._finish_reason[slot]

    def release_slot(self, slot: int) -> None:
        """Free a lane regardless of progress; mid-prefill state is
        discarded and the lane is zeroed at its next claim."""
        self.active[slot] = False
        self._prefilling[slot] = False
        self._pending_prompt.pop(slot, None)
        self._pending_logits.pop(slot, None)

    def free_slots(self) -> int:
        """Slots claimable right now (neither decoding nor mid-prefill)."""
        return int(np.sum(~self.active & ~self._prefilling))

    # ----------------------------------------------------------- sampling
    def _resolve_sampling(self, key: Optional[int], slot: int) -> bool:
        """Whether ``slot``'s first token is sampled: its temperature is
        above 0 and it has a key or a seed. Without either it warns and
        falls back to the argmax."""
        if self._temp[slot] <= 0:
            return False
        if self._seed[slot] >= 0:
            return True
        if key is None:
            warnings.warn(
                "temperature > 0 but no sampling key passed: falling back "
                "to greedy argmax for this token. Pass key= to sample "
                "(Engine.step applies the same key-gated rule), or set "
                "SamplingParams.seed for a self-seeded request.",
                UserWarning, stacklevel=3)
            return False
        return True

    def _effective_temps(self, key: Optional[int]) -> np.ndarray:
        """Per-lane temperatures in effect for one sampling event: a lane
        without entropy (no key, no seed) takes the argmax."""
        if key is not None:
            return self._temp.copy()
        return np.where(self._seed >= 0, self._temp,
                        0.0).astype(np.float32)

    def _choose(self, logits: torch.Tensor, sample: bool,
                key: Optional[int], lanes: np.ndarray) -> torch.Tensor:
        """(B,) int32 ids on the device from (B, V) logits: the argmax, or
        the per-lane sampled selection, whose event counts then advance in
        the seeded lanes among ``lanes``."""
        with named_scope("engine.choose"):
            if not sample:
                return torch.argmax(logits, dim=-1).to(torch.int32)
            eff = self._effective_temps(key)
            keys = sampling.lane_keys(key if key is not None else 0,
                                      self._seed, self._ctr)
            ids = sampling.select(logits, self._snapshot(eff),
                                  self._snapshot(keys))
            self._ctr[lanes & (eff > 0) & (self._seed >= 0)] += 1
            return ids

    def _reset_slot_state(self, slot: int) -> None:
        """Zero one lane's cache before a freed slot hosts a new request:
        its KV rows and rings, recurrent states and conv windows (every
        cache tensor has the lane on its first axis)."""
        for layer in self.cache["layers"]:
            for t in layer.values():
                t[slot].zero_()

    def _bucket(self, n: int) -> int:
        b = self.cfg.prefill_bucket_min
        while b < n:
            b *= 2
        return b

    def _prefill_chunk(self, slot: int, chunk: List[int]) -> torch.Tensor:
        """One bucketed prefill dispatch: the chunk is right-padded to its
        bucket and every other lane rides along frozen (length 0). Returns
        the last-valid-token logits (B, V) on the device."""
        bucket = self._bucket(len(chunk))
        toks = np.zeros((self.cfg.batch_slots, bucket), np.int64)
        toks[slot, :len(chunk)] = chunk
        lens = np.zeros(self.cfg.batch_slots, np.int64)
        lens[slot] = len(chunk)
        logits, _ = self._prefill(toks, self.lengths, lens, keep=True)
        self.lengths[slot] += len(chunk)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += len(chunk)
        return logits

    def _prefill(self, toks: np.ndarray, index: np.ndarray,
                 lens: np.ndarray, keep: bool = False):
        """One ``prefill_step`` dispatch of the served arch: ``toks`` (B,
        bucket) at cache offsets ``index``, ``lens`` valid tokens a lane
        (0 freezes it). Returns the last valid token's logits (B, V) and
        the greedy ids at every position (B, bucket), on the device; the
        cache is written in place. Replayed from the bucket's graph where
        there is one, whose buffers the next replay overwrites: ``keep``
        returns the logits in a copy of their own."""
        key = f"prefill[bucket={toks.shape[1]}]"
        graph = self._graph(key)
        if graph is not None:
            logits, ids = self._dispatch(key, self._replay, graph, toks,
                                         index, lens)
            return (logits.clone() if keep else logits), ids
        logits, ids, self.cache = self._dispatch(
            key, prefill_step, self.params, self._snapshot(toks), self.arch,
            self.cache, self._snapshot(index), self._snapshot(lens))
        return logits, ids

    def _decode(self, toks: np.ndarray, mask: np.ndarray,
                arch: Optional[ArchConfig] = None,
                index: Optional[np.ndarray] = None) -> torch.Tensor:
        """One decode forward over the whole batch, of ``arch`` (None: the
        served one) at cache offsets ``index`` (None: the lengths); lanes
        outside ``mask`` keep their caches. Returns the logits (B, V) on
        the device."""
        index = self.lengths if index is None else index
        graph = (self._graph("decode") if arch is None or arch is self.arch
                 else None)
        if graph is not None:
            return self._replay(graph, toks.astype(np.int64), index,
                                mask)[0]
        params = self.params if arch is None else self._draft_params_of(arch)
        logits, self.cache = decode_step(
            params, self._snapshot(toks.astype(np.int64)), arch or self.arch,
            self.cache, self._snapshot(index), active=self._snapshot(mask))
        return logits

    def _decode_choose(self, toks: np.ndarray, mask: np.ndarray,
                       sample: bool, key: Optional[int],
                       arch: Optional[ArchConfig] = None,
                       index: Optional[np.ndarray] = None) -> torch.Tensor:
        """A decode dispatch: the forward and the token selection, (B,)
        int32 ids on the device."""
        return self._choose(self._decode(toks, mask, arch, index), sample,
                            key, mask)

    def _advance_slot(self, slot: int, token: int, sample: bool = False,
                      key: Optional[int] = None) -> int:
        """Token-by-token prefill: a batched decode with every lane but
        ``slot`` frozen. Returns this slot's next token, sampled when
        ``sample`` (the first generated token on the final prompt
        token)."""
        toks = np.zeros((self.cfg.batch_slots, 1), np.int32)
        toks[slot, 0] = token
        mask = np.zeros(self.cfg.batch_slots, bool)
        mask[slot] = True
        ids = self._dispatch(f"decode[sample={sample}]", self._decode_choose,
                             toks, mask, sample, key)
        self.lengths[slot] += 1
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += 1
        return int(self._fetch(ids)[slot])

    # ------------------------------------------------------------ decode
    def step(self, key: Optional[int] = None) -> StepResult:
        """One decode step for every active slot: lanes with a positive
        temperature and a key (``key``) or a seed sample, the others take
        the argmax.

        Returns a ``StepResult`` (slot id -> token) whose ``finished`` lists
        the slots freed this step — EOS, ``max_tokens``, or no context left
        for another decode write — after those that completed at prefill
        time. Freed slots leave the active mask and are claimable at once.
        """
        pending, outputs = self._drain_pending()
        if not self.active.any():
            return StepResult({}, pending, self._pj_per_token, outputs)
        sample = bool((self._effective_temps(key)[self.active] > 0).any())
        ids = self._fetch(self._dispatch(
            f"decode[sample={sample}]", self._decode_choose,
            self._last_host[:, None], self.active, sample, key))
        act = np.where(self.active)[0]
        out = {}
        for s in act:
            t = int(ids[s])
            self.tokens[s].append(t)
            out[int(s)] = t
        self._last_host[act] = ids[act]
        self.lengths[act] += 1
        self._emitted[act] += 1
        hit_eos = (self._eos >= 0) & (self._last_host == self._eos)
        maxed = (self._max_toks >= 0) & (self._emitted >= self._max_toks)
        done = self.active & (hit_eos | maxed
                              | (self.lengths >= self.cfg.max_ctx))
        for s in act:
            reason = None
            if done[s]:
                reason = ("eos" if hit_eos[s]
                          else "length" if maxed[s] else "ctx")
                self._finish_reason[s] = reason
            outputs.append(RequestOutput(
                slot=int(s), tokens=[out[int(s)]], finished=bool(done[s]),
                finish_reason=reason, _energy_fn=self._pj_per_token))
        finished = pending + [int(s) for s in np.where(done)[0]]
        self.active[done] = False
        self.stats["decode_steps"] += 1
        return StepResult(out, finished, self._pj_per_token, outputs)

    def _drain_pending(self):
        """Pop the completions recorded outside ``step`` (a first token that
        hit EOS or a one-token cap): their slot ids and token-less
        ``RequestOutput`` records."""
        pending, self._pending_finished = self._pending_finished, []
        outputs = [RequestOutput(slot=s, tokens=[], finished=True,
                                 finish_reason=self._finish_reason[s],
                                 _energy_fn=self._pj_per_token)
                   for s in pending]
        return pending, outputs

    # ------------------------------------------------- speculative seams
    _SPEC_STATE_KINDS = ("local", "rglru", "ssm")

    def spec_snapshot(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """Copies (whole batch) of the cache tensors a draft or a verify can
        spoil: local-attention rings (a write at ``pos % window`` destroys
        a valid older row) and RG-LRU / SSM states with their conv windows
        (changed by every pass), by layer index. Global-attention KV needs
        none: rows past a lane's length stay masked until overwritten. An
        empty dict: the arch needs no rollback."""
        return {i: {name: t.clone() for name, t in layer.items()}
                for i, (kind, layer) in enumerate(zip(self.arch.blocks(),
                                                      self.cache["layers"]))
                if kind in self._SPEC_STATE_KINDS}

    def spec_restore(self, snap: Dict[int, Dict[str, torch.Tensor]],
                     lanes: np.ndarray) -> None:
        """Copy ``snap`` back into the lanes where ``lanes`` is True, in
        place; the other lanes keep their current state. Nothing crosses
        to the host."""
        if not snap or not lanes.any():
            return
        idx = self._snapshot(np.where(lanes)[0])
        for i, layer in snap.items():
            cur = self.cache["layers"][i]
            for name, old in layer.items():
                cur[name].index_copy_(0, idx, old.index_select(0, idx))

    def _draft_params_of(self, draft_arch: ArchConfig) -> dict:
        """Params a draft arch runs on: the served ones for the served arch
        (``"self"``), else prepared from the raw weights once and kept."""
        if draft_arch not in self._draft_params:
            self._draft_params[draft_arch] = self._prepared(
                self._raw_params, draft_arch)
        return self._draft_params[draft_arch]

    def draft_step(self, draft_arch: ArchConfig, cur: np.ndarray,
                   mask: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """One greedy decode dispatch of ``draft_arch`` (same weights,
        shared cache) for the lanes in ``mask``, feeding ``cur[i]`` at
        cache offset ``offsets[i]``; the other lanes feed 0 and keep their
        caches. Returns the drafted ids (one fetch)."""
        toks = np.zeros((self.cfg.batch_slots, 1), np.int64)
        toks[mask, 0] = cur[mask]
        # the "self" drafter is the greedy decode dispatch itself, on the
        # decode step's index type; another draft arch keeps int64 offsets
        own = draft_arch is self.arch
        key = "decode[sample=False]" if own else "draft[sample=False]"
        index = offsets.astype(self.lengths.dtype if own else np.int64)
        ids = self._dispatch(key, self._decode_choose, toks, mask, False,
                             None, draft_arch, index)
        self.stats["draft_dispatches"] += 1
        return self._fetch(ids)

    def _chunk_tokens(self, chunk: np.ndarray) -> np.ndarray:
        """``chunk`` (B, k) right-padded with zeros to its bucket."""
        b, k = chunk.shape
        toks = np.zeros((b, self._bucket(k)), np.int64)
        toks[:, :k] = chunk
        return toks

    def verify_chunk(self, chunk: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
        """Exact greedy verification of ``chunk`` (per lane ``[pending,
        d_1 .. d_{k-1}]``, ``lens`` valid entries, 0 freezes the lane)
        through the bucketed prefill: ``prefill_step``'s per-position argmax
        ids, (B, k), one fetch. Lengths are not committed here."""
        _, ids = self._prefill(self._chunk_tokens(chunk), self.lengths,
                               lens.astype(np.int64))
        self.stats["verify_dispatches"] += 1
        return self._fetch(ids)[:, :chunk.shape[1]]

    def verify_chunk_sampled(self, chunk: np.ndarray, lens: np.ndarray,
                             key: Optional[int]):
        """Rejection-rule verification of ``chunk`` under per-lane
        temperatures (``_verify_sampled``), lanes at temperature 0 exact
        greedy. Returns (emitted tokens (B, k), emitted counts (B,)) from
        one packed fetch."""
        k = chunk.shape[1]
        toks = self._snapshot(self._chunk_tokens(chunk))
        eff = self._effective_temps(key)
        keys = sampling.lane_keys(key if key is not None else 0,
                                  self._seed, self._ctr)
        halves = np.array([sampling.split(int(lk), 2) for lk in keys],
                          dtype=np.uint64) & np.uint64(0xFFFFFFFF)
        packed = self._dispatch(
            f"verify[bucket={toks.shape[1]}]", self._verify_sampled,
            toks, self._snapshot(lens.astype(np.int64)),
            self._snapshot(halves[:, 0].astype(np.int64)),
            self._snapshot(halves[:, 1].astype(np.int64)),
            self._snapshot(eff))
        self._ctr[(lens > 0) & (eff > 0) & (self._seed >= 0)] += 1
        self.stats["verify_dispatches"] += 1
        packed = self._fetch(packed)
        return packed[:, :k], packed[:, toks.shape[1]]

    def _verify_sampled(self, toks: torch.Tensor, lens: torch.Tensor,
                        keys_u: torch.Tensor, keys_c: torch.Tensor,
                        temp: torch.Tensor) -> torch.Tensor:
        """The reference's ``_verify_raw`` on the device: a chunked prefill
        over ``[pending, d_1 .. d_{k-1}]`` and the speculative rejection
        rule. Drafts are greedy (a point proposal), so draft ``d_j`` is
        accepted with probability ``p(d_j)`` under the target softmax at
        T; at the first rejection the final token is drawn from ``p``
        with the rejected token removed, after full acceptance from the
        next position's ``p`` (the bonus token). Uniforms come from
        ``keys_u``, the final draw's Gumbel noise from ``keys_c``; lanes
        with T <= 0 accept exactly the greedy ids. Returns (B, S + 1)
        int32: the emitted tokens, then their count."""
        b, s = toks.shape
        idx = self._snapshot(self.lengths.astype(np.int64))
        steps = torch.arange(s, device=toks.device)
        logits, _, self.cache = forward(
            self.params, toks, self.arch, cache=self.cache, cache_index=idx,
            positions=idx[:, None] + steps[None, :], chunk_lengths=lens)
        greedy = torch.argmax(logits, dim=-1)
        # position j verifies draft toks[:, j + 1] (the last column is
        # masked off by draft_pos)
        nxt = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
        p = torch.softmax(logits.to(torch.float32)
                          / temp.clamp(min=1e-6)[:, None, None], dim=-1)
        q = torch.gather(p, -1, nxt[..., None])[..., 0]
        u = sampling.uniform(keys_u, s)
        acc = torch.where((temp > 0)[:, None], u < q, nxt == greedy)
        draft_pos = steps[None, :] < (lens[:, None] - 1)
        run = torch.cumprod(torch.where(draft_pos, acc, True).to(
            torch.int32), dim=1)
        m = torch.sum(run * draft_pos.to(torch.int32), dim=1)       # (B,)
        rows = torch.arange(b, device=toks.device)
        row = logits[rows, m]
        rejected = m < (lens - 1)
        d_rej = nxt[rows, m]
        vocab = torch.arange(row.shape[-1], device=toks.device)
        row_f = torch.where(rejected[:, None] & (vocab == d_rej[:, None]),
                            torch.tensor(-1e30, device=toks.device),
                            row.to(torch.float32))
        final = torch.where(temp > 0, sampling.select(row_f, temp, keys_c),
                            torch.argmax(row, dim=-1).to(torch.int32))
        emitted = torch.where(steps[None, :] < m[:, None], nxt,
                              torch.zeros_like(nxt))
        emitted = torch.where(steps[None, :] == m[:, None],
                              final[:, None].to(nxt.dtype), emitted)
        return torch.cat([emitted, (m + 1)[:, None].to(nxt.dtype)],
                         dim=1).to(torch.int32)

    def repair_chunk(self, chunk: np.ndarray, lens: np.ndarray,
                     index: np.ndarray) -> None:
        """After ``spec_restore`` rolled the partially accepted lanes back,
        re-feed each one's accepted prefix (``lens[i]`` leading tokens of
        ``chunk``, 0: frozen) at its pre-verify offset ``index``. No fetch:
        acceptance already knows every token."""
        # the prefill dispatch of admission, on its index type
        self._prefill(self._chunk_tokens(chunk),
                      index.astype(self.lengths.dtype),
                      lens.astype(np.int64))
        self.stats["repair_dispatches"] += 1

    # ------------------------------------------------------------ energy
    def energy_per_token(self) -> Optional[dict]:
        """Decode-phase energy report of the served arch: the ledger of one
        decode step at batch 1, priced per site per generated token with
        the Monte-Carlo solve on this engine's device. Computed once per
        engine; None when the arch's CIM path is off."""
        if not self.arch.cim.enabled:
            return None
        if self._energy is None:
            self._energy = costs.price_ledger(
                costs.trace_decode(self.arch), 1, device=self.device)
            self.stats["pj_per_token"] = self._energy["pj_per_token"]
        return self._energy

    def _pj_per_token(self) -> Optional[float]:
        rep = self.energy_per_token()
        return None if rep is None else rep["pj_per_token"]

    @staticmethod
    def _fetch(ids_dev: torch.Tensor) -> np.ndarray:
        """The single device→host transfer of a dispatch that needs one: a
        (batch_slots,) int32 id array per decode or draft step and per
        first-token selection, a (batch_slots, bucket[+1]) int32 array per
        speculative verify; a repair crosses nothing. The host waits for
        the device here, in the scope ``engine.fetch``."""
        with named_scope("engine.fetch"):
            return ids_dev.cpu().numpy()


def energy_report(arch: ArchConfig, *, batch: int = 1,
                  prefill_bucket: int = 128,
                  train_seq: Optional[int] = None,
                  seed: int = 0, n_cols: int = 1 << 11,
                  device: Optional[Union[str, torch.device]] = None) -> dict:
    """Ledger-derived CIM energy report (pJ/token) of the three phases:
    ``core.costs`` ledgers of one ``prefill_bucket``-token prefill
    dispatch, one decode step and one train forward, each contract priced
    at its site's resolved design. The top-level keys alias the decode
    phase; ``phases`` holds every phase per site. ``seed`` / ``n_cols``
    configure the Monte-Carlo ENOB solve, which draws on ``device`` (None:
    the card)."""
    if not arch.cim.enabled:
        return {"enabled": False}
    phases = costs.phase_report(arch, batch=batch,
                                prefill_bucket=prefill_bucket,
                                train_seq=train_seq, seed=seed,
                                n_cols=n_cols, device=device)
    dec = phases["decode"]
    return {
        "enabled": True,
        "phases": phases,
        "fj_per_op": dec["fj_per_op"],
        "conventional_fj_per_op": dec["conventional_fj_per_op"],
        "ops_per_token": dec["ops_per_token"],
        "analog_ops_per_token": dec["analog_ops_per_token"],
        "pj_per_token": dec["pj_per_token"],
        "sites": dec["sites"],
    }
