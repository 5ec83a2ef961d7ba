"""Batched serving engine: slot-based continuous batching over a fixed-size
decode batch with chunked, length-bucketed prefill and greedy decode.

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
done here by restoring the one row a decode writes). The host sees
exactly one device→host transfer per step, a ``(batch_slots,)`` int32
array of ids, and one per first-token selection, all through ``_fetch``.

Incremental prefill: ``begin_request`` claims a slot, ``advance_prefill``
runs one bucketed chunk, ``finish_prefill`` selects the first token and
activates the lane; ``add_request`` is their blocking composition.
``release_slot`` frees a lane; ``free_slots`` counts claimable ones.

Weights: the engine packs every CIM site's weight once at construction
(``models.pack_params``: the per-call pre-scale and quantization of the
reference done once, stored as 4-bit or 8-bit format codes), so a
dispatch re-quantizes no weight. ``cim_backend="ref"`` keeps the raw
weights and the per-call path: it is the independent oracle.

Not ported yet: sampling (``temperature > 0`` raises), the prefix cache,
the speculative-decode seams and the energy report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import require_full_f32, resolve_device
from repro_torch.models import (decode_step, init_cache,
                                pack_params, prefill_step)
from repro_torch.serving.params import RequestOutput, SamplingParams

__all__ = ["ServeConfig", "Engine", "StepResult", "SamplingParams",
           "RequestOutput"]


class StepResult(dict):
    """``Engine.step`` result: slot id -> token emitted this step, plus
    ``finished`` — the slot ids freed this step (EOS, ``max_tokens``, or
    context exhaustion, and completions recorded at prefill time), in
    ascending slot order — and ``outputs``, a ``RequestOutput`` per live
    request. ``pj_per_token`` is None until the energy model is ported."""

    pj_per_token = None

    def __init__(self, tokens: dict, finished: List[int],
                 outputs: Optional[List[RequestOutput]] = None):
        super().__init__(tokens)
        self.finished = finished
        self.outputs: List[RequestOutput] = outputs if outputs is not None \
            else []


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


class Engine:
    def __init__(self, arch: ArchConfig, params, cfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_full_f32()
        if arch.input_mode != "tokens":
            raise ValueError("the engine serves token models")
        if cfg.temperature > 0:
            raise NotImplementedError(
                "sampling (temperature > 0) is not ported yet")
        if cfg.prefill_mode not in ("bucketed", "token"):
            raise ValueError(f"unknown prefill_mode {cfg.prefill_mode!r}")
        if cfg.cim_backend is not None:
            arch = arch.replace(cim=arch.cim.with_backend(cfg.cim_backend))
        self.arch = arch
        self.cfg = cfg
        self.params = (params if arch.cim.backend == "ref"
                       else pack_params(params, arch))
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
        self.stats = {"prefill_dispatches": 0, "decode_steps": 0,
                      "prefill_tokens": 0}

    def _snapshot(self, host_state: np.ndarray) -> torch.Tensor:
        """A device copy of mutable per-slot host state. ``torch.tensor``
        always copies (``from_numpy``/``as_tensor`` would alias a CPU
        array, which the engine mutates right after dispatching)."""
        return torch.tensor(host_state, device=self.device)

    # ------------------------------------------------------------ prefill
    def add_request(self, prompt: List[int], *,
                    params: Optional[SamplingParams] = None) -> int:
        """Prefill a free slot, select the first output token from the
        prefill logits, and return the slot id. A first token that hits
        the request's EOS (or a one-token cap) finishes the request at
        once; it is reported by the next ``step``."""
        slot = self.begin_request(prompt, params=params)
        if self.cfg.prefill_mode == "token":
            self._pending_prompt.pop(slot, None)
            for t in prompt[:-1]:
                self._advance_slot(slot, t)
            # the final dispatch's ids ARE the last-valid-token selection
            self._adopt_first_token(slot, self._advance_slot(slot, prompt[-1]))
        else:
            while self.prefill_remaining(slot):
                self.advance_prefill(slot)
            self.finish_prefill(slot)
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
        temp = (self.cfg.temperature if params.temperature is None
                else params.temperature)
        if temp > 0:
            raise NotImplementedError(
                "sampling (temperature > 0) is not ported yet")
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
        self._finish_reason[slot] = None
        return slot

    def prefill_remaining(self, slot: int) -> int:
        """Prompt tokens of ``slot`` not yet prefilled (0 once drained)."""
        return len(self._pending_prompt.get(slot, ()))

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
        self._pending_logits[slot] = self._prefill_chunk(slot, rem[:take])
        del rem[:take]
        return take

    def finish_prefill(self, slot: int) -> int:
        """Select the first output token (greedy) from the final chunk's
        logits and activate the lane (or finish it at once)."""
        if self.prefill_remaining(slot):
            raise RuntimeError(
                f"slot {slot}: {self.prefill_remaining(slot)} prompt "
                "tokens still pending — drain with advance_prefill first")
        logits = self._pending_logits.pop(slot)
        del self._pending_prompt[slot]
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        first = int(self._fetch(ids)[slot])
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

    def _reset_slot_state(self, slot: int) -> None:
        """Zero one lane's cache before a freed slot hosts a new request."""
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
        logits, _, self.cache = prefill_step(
            self.params, self._snapshot(toks), self.arch, self.cache,
            self._snapshot(self.lengths), self._snapshot(lens))
        self.lengths[slot] += len(chunk)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += len(chunk)
        return logits

    def _decode(self, toks: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """One decode dispatch over the whole batch; lanes outside ``mask``
        keep their caches. Returns the greedy ids (B,) int32 on the
        device."""
        logits, self.cache = decode_step(
            self.params, self._snapshot(toks.astype(np.int64)), self.arch,
            self.cache, self._snapshot(self.lengths),
            active=self._snapshot(mask))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _advance_slot(self, slot: int, token: int) -> int:
        """Token-by-token prefill: a batched decode with every lane but
        ``slot`` frozen. Returns this slot's greedy next token (the first
        generated token on the final prompt token)."""
        toks = np.zeros((self.cfg.batch_slots, 1), np.int32)
        toks[slot, 0] = token
        mask = np.zeros(self.cfg.batch_slots, bool)
        mask[slot] = True
        ids = self._decode(toks, mask)
        self.lengths[slot] += 1
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += 1
        return int(self._fetch(ids)[slot])

    # ------------------------------------------------------------ decode
    def step(self) -> StepResult:
        """One greedy decode step for every active slot.

        Returns a ``StepResult`` (slot id -> token) whose ``finished`` lists
        the slots freed this step — EOS, ``max_tokens``, or no context left
        for another decode write — after those that completed at prefill
        time. Freed slots leave the active mask and are claimable at once.
        """
        pending, self._pending_finished = self._pending_finished, []
        outputs = [RequestOutput(slot=s, tokens=[], finished=True,
                                 finish_reason=self._finish_reason[s])
                   for s in pending]
        if not self.active.any():
            return StepResult({}, pending, outputs)
        ids = self._fetch(self._decode(self._last_host[:, None], self.active))
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
                finish_reason=reason))
        finished = pending + [int(s) for s in np.where(done)[0]]
        self.active[done] = False
        self.stats["decode_steps"] += 1
        return StepResult(out, finished, outputs)

    @staticmethod
    def _fetch(ids_dev: torch.Tensor) -> np.ndarray:
        """The single device→host transfer of a dispatch that needs one: a
        (batch_slots,) int32 id array per decode step and per first-token
        selection."""
        return ids_dev.cpu().numpy()
