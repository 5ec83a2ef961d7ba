"""Self-speculative multi-token decode with exact verification; the port's
counterpart of ``repro.serving.speculative``.

Each iteration drafts ``k - 1`` tokens per lane with a cheap configuration
of the *same* model on the *same* cache, then verifies them all in one
chunked dispatch through the served (exact) path and keeps the longest
accepted prefix. No second model, no draft prefill, no draft cache.

Draft policies (``SpecConfig.draft``): ``"digital"`` (the same arch with
the CIM path off; its params are the raw weights, which the engine keeps
beside the packed ones), ``"self"`` (the served arch: greedy acceptance is
total), a ``site_overrides`` dict, a ``CIMConfig`` or a whole
``ArchConfig`` of the same model.

Greedy acceptance: the verify chunk is ``[pending, d_1 .. d_{k-1}]``
through the bucketed prefill, whose per-position argmax ids are the
target's greedy continuation after each prefix; a lane accepts ``a = 1 +
(longest draft prefix equal to those ids)`` tokens, the ids' first ``a``.
Every emitted token is conditioned on accepted (correct) inputs only, so
greedy speculative streams equal sequential decode's whatever the drafter
does — with the CIM path off. In GR-MAC mode the pre-scale's absmax runs
over a whole dispatch (all lanes, all chunk positions), so a verify chunk
need not see what token-by-token decode sees, in the reference too.

Sampled acceptance (``Engine.verify_chunk_sampled``): the textbook
rejection rule for a greedy (point) proposal, on the device, drawing from
``serving.sampling`` keys; distributed as sequential sampling, not equal
to it token by token. Lanes at temperature 0 accept exactly as greedy.

Rollback: global KV needs none (rows past a lane's length stay masked
until overwritten; MoE FFNs are stateless). Local rings and RG-LRU / SSM
states do: the step is::

    S0 = spec_snapshot -> k - 1 draft dispatches -> spec_restore(S0) ->
    one verify dispatch -> acceptance on the host -> for live lanes that
    accepted a strict prefix: spec_restore(S0) + one repair dispatch that
    re-feeds the accepted tokens at the pre-verify offsets (no fetch)

Energy (``price_speculation``): draft dispatches at the draft arch's
decode pJ/token (a digital draft at the target ledger's conventional
fJ/Op), verify and repair dispatches at ``bucket`` x the prefill
pJ/token, over the accepted tokens; against sequential decode's pJ/token.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import costs
from repro_torch.core.cim_config import CIMConfig
from repro_torch.serving.engine import Engine, RequestOutput, StepResult

__all__ = ["SpecConfig", "SpecDecoder", "draft_arch_for",
           "price_speculation"]

DraftPolicy = Union[str, dict, CIMConfig, ArchConfig]


def draft_arch_for(arch: ArchConfig, draft: DraftPolicy) -> ArchConfig:
    """The draft ArchConfig of a ``SpecConfig.draft`` policy: always the
    same model (weights, cache layout); only the CIM config may differ."""
    if isinstance(draft, str):
        if draft == "self":
            return arch
        if draft == "digital":
            return arch.replace(cim=arch.cim.with_mode("off"))
        raise ValueError(
            f"unknown draft policy {draft!r} (choices: 'self', 'digital', "
            "a site_overrides dict, a CIMConfig, or an ArchConfig)")
    if isinstance(draft, dict):
        return arch.replace(cim=arch.cim.with_site_overrides(draft))
    if isinstance(draft, CIMConfig):
        return arch.replace(cim=draft)
    if isinstance(draft, ArchConfig):
        if (draft.n_layers, draft.d_model, draft.block_pattern) != \
                (arch.n_layers, arch.d_model, arch.block_pattern):
            raise ValueError(
                "draft ArchConfig must be the same model as the target "
                "(self-speculation shares weights and cache)")
        return draft
    raise ValueError(f"unsupported draft policy: {draft!r}")


@dataclasses.dataclass
class SpecConfig:
    """``k``: tokens scored per lane per iteration (1 pending + ``k - 1``
    drafts); a request's ``SamplingParams.spec_k`` overrides it
    (``spec_k=1`` opts out). ``draft``: the drafter (module docstring)."""
    k: int = 4
    draft: DraftPolicy = "digital"

    def __post_init__(self):
        if self.k < 2:
            raise ValueError(f"SpecConfig.k must be >= 2, got {self.k}")


class SpecDecoder:
    """A multi-token ``Engine.step``: each ``step()`` emits 1 to ``k``
    tokens per live lane through draft, verify, accept and (restore +
    repair). ``Scheduler(..., spec=...)`` drives it like the engine.

    ``draft_fn``, a test seam: ``(cur_tokens (B,), t) -> (B,) ids`` in
    place of the draft dispatches (forced mismatches for the rollback
    tests); nothing then pollutes the cache before the verify."""

    def __init__(self, engine: Engine, cfg: Optional[SpecConfig] = None, *,
                 draft_fn: Optional[Callable] = None):
        self.engine = engine
        self.cfg = cfg or SpecConfig()
        self.draft_arch = draft_arch_for(engine.arch, self.cfg.draft)
        self.draft_fn = draft_fn

    def _lane_budgets(self) -> np.ndarray:
        """Per-lane chunk sizes: the request's spec_k (else ``k``), capped
        so the verify writes within max_ctx and emits within max_tokens;
        at least 1 (sequential)."""
        eng = self.engine
        k_arr = np.ones(eng.cfg.batch_slots, np.int64)
        for s in np.where(eng.active)[0]:
            k = int(eng._spec_k[s]) if eng._spec_k[s] >= 1 else self.cfg.k
            k = min(k, eng.cfg.max_ctx - int(eng.lengths[s]))
            if eng._max_toks[s] >= 0:
                k = min(k, int(eng._max_toks[s] - eng._emitted[s]))
            k_arr[s] = max(1, k)
        return k_arr

    def step(self, key: Optional[int] = None) -> StepResult:
        """One speculative iteration over the active slots, returned as
        ``Engine.step`` returns (slot -> its last token this step;
        ``outputs`` carry every emitted token). Falls through to
        ``Engine.step`` when no lane has a budget above 1."""
        eng = self.engine
        if not eng.active.any():
            return eng.step(key)
        k_arr = self._lane_budgets()
        if int(k_arr.max()) <= 1:
            return eng.step(key)
        pending, outputs = eng._drain_pending()
        act = eng.active.copy()
        base_len = eng.lengths.copy()
        spec = act & (k_arr > 1)
        n_draft = int(k_arr.max()) - 1

        # draft: n_draft greedy decode dispatches on the shared cache
        snap = eng.spec_snapshot()
        cur = eng._last_host.copy()
        drafts = np.zeros((n_draft, eng.cfg.batch_slots), np.int32)
        drafted = False
        for t in range(n_draft):
            mask = spec & ((k_arr - 1) > t)
            if self.draft_fn is not None:
                ids = np.asarray(self.draft_fn(cur.copy(), t), np.int32)
            else:
                offs = np.minimum(base_len + t, eng.cfg.max_ctx - 1)
                ids = eng.draft_step(self.draft_arch, cur, mask, offs)
                drafted = True
            drafts[t] = np.where(mask, ids, 0)
            cur = np.where(mask, ids, cur)
        if drafted:
            # undo the drafts' writes to rings and recurrent states before
            # the exact verify re-feeds those positions
            eng.spec_restore(snap, spec)

        # verify: one chunked dispatch through the served path
        kmax = int(k_arr.max())
        chunk = np.zeros((eng.cfg.batch_slots, kmax), np.int32)
        chunk[:, 0] = eng._last_host
        chunk[:, 1:] = drafts.T
        lens = np.where(act, k_arr, 0).astype(np.int32)
        eff = eng._effective_temps(key)
        if bool((eff[act] > 0).any()):
            emitted_arr, a_arr = eng.verify_chunk_sampled(chunk, lens, key)
            a_arr = a_arr.astype(np.int64)
        else:
            tgt = eng.verify_chunk(chunk, lens)
            a_arr = np.zeros(eng.cfg.batch_slots, np.int64)
            emitted_arr = np.zeros_like(chunk)
            for s in np.where(act)[0]:
                m = 0
                while m < k_arr[s] - 1 and chunk[s, m + 1] == tgt[s, m]:
                    m += 1
                a_arr[s] = m + 1
                # accepted drafts are the target ids; entry m is the
                # correction (first mismatch) or the bonus (all matched)
                emitted_arr[s, :m + 1] = tgt[s, :m + 1]

        # commit the accepted prefixes; collect repairs
        out = {}
        finished = list(pending)
        repair_mask = np.zeros(eng.cfg.batch_slots, bool)
        repair_lens = np.zeros(eng.cfg.batch_slots, np.int32)
        total = 0
        for s in np.where(act)[0]:
            s = int(s)
            a = int(a_arr[s])
            toks_s = [int(x) for x in emitted_arr[s, :a]]
            reason = None
            eos = int(eng._eos[s])
            if eos >= 0 and eos in toks_s:
                a = toks_s.index(eos) + 1
                toks_s = toks_s[:a]
                reason = "eos"
            eng.tokens[s].extend(toks_s)
            eng.lengths[s] += a
            eng._emitted[s] += a
            eng._last_host[s] = toks_s[-1]
            out[s] = toks_s[-1]
            total += a
            if reason is None:
                if 0 <= eng._max_toks[s] <= eng._emitted[s]:
                    reason = "length"
                elif eng.lengths[s] >= eng.cfg.max_ctx:
                    reason = "ctx"
            if reason is not None:
                eng._finish_reason[s] = reason
                eng.active[s] = False
                finished.append(s)
            elif a < int(k_arr[s]):
                # a live lane accepted a strict prefix: its ring / recurrent
                # state ran past the commit point (a finished lane is
                # zeroed at its next claim instead)
                repair_mask[s] = True
                repair_lens[s] = a
            outputs.append(RequestOutput(
                slot=s, tokens=toks_s, finished=reason is not None,
                finish_reason=reason, _energy_fn=eng._pj_per_token))
        if repair_mask.any() and snap:
            eng.spec_restore(snap, repair_mask)
            eng.repair_chunk(chunk, repair_lens, base_len)
        eng.stats["spec_steps"] += 1
        eng.stats["spec_tokens"] += total
        return StepResult(out, finished, eng._pj_per_token, outputs=outputs)


# ------------------------------------------------------------------ energy
def price_speculation(arch: ArchConfig, draft_arch: ArchConfig,
                      stats: dict, verify_bucket: int, *, seed: int = 0,
                      n_cols: int = 1 << 11, device=None) -> dict:
    """pJ per accepted token of draft + verify against sequential decode,
    from measured dispatch counters (``Engine.stats``) and the cost
    ledgers of the model functions; the Monte-Carlo solves draw on
    ``device`` (None: the card). Deterministic for fixed inputs."""
    if not arch.cim.enabled:
        return {"enabled": False}
    kw = dict(seed=seed, n_cols=n_cols, device=device)
    dec = costs.price_ledger(costs.trace_decode(arch), 1, **kw)
    pre = costs.price_ledger(costs.trace_prefill(arch, bucket=verify_bucket),
                             verify_bucket, **kw)
    if draft_arch.cim.enabled:
        draft_pj = costs.price_ledger(costs.trace_decode(draft_arch), 1,
                                      **kw)["pj_per_token"]
    else:
        # a digital draft: the same ops at the target's conventional point
        draft_pj = dec["conventional_pj_per_token"]
    chunk_pj = pre["pj_per_token"] * verify_bucket
    accepted = max(1, int(stats["spec_tokens"]))
    steps = max(1, int(stats["spec_steps"]))
    spec_pj = (stats["draft_dispatches"] * draft_pj
               + (stats["verify_dispatches"]
                  + stats["repair_dispatches"]) * chunk_pj) / accepted
    return {
        "enabled": True,
        "verify_bucket": verify_bucket,
        "seq_pj_per_token": dec["pj_per_token"],
        "draft_pj_per_dispatch": draft_pj,
        "verify_pj_per_dispatch": chunk_pj,
        "spec_pj_per_accepted_token": spec_pj,
        "accepted_tokens_per_step": stats["spec_tokens"] / steps,
        "energy_win": bool(spec_pj < dec["pj_per_token"]),
    }
