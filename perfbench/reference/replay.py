"""The closed-loop serving policy, replayed on the reference.

The port batches requests into dispatches of ``slots`` lanes, and the
pre-scale of every GR-MAC projection takes one max |x| over the whole
dispatch, so a token's logits depend on every lane beside it: frozen
lanes, padding and the state a finished request left in its lane
included. The reference therefore judges dispatch by dispatch, with all
lanes, and derives the dispatches itself from the traffic by the policy
the cell states (not from the port's state):

* clients: ``clients`` requests in flight; a client submits its next
  request before the scheduler step that follows its previous one's end;
* admission: first come first served into the lowest free lane, whose
  cache is zeroed if it served before;
* prefill: at most ``budget`` prompt tokens a step, spent over the
  prefilling requests in admission order, a chunk at most
  ``bucket_max`` tokens, right-padded to a power-of-two bucket from
  ``bucket_min``; the other lanes ride along with length 0 at their own
  offsets; a drained prompt's first token is the argmax of its last
  chunk's last valid logits, and the request decodes from the same step;
* decode: one step of every lane at its own offset, each feeding its last
  token; lanes not decoding keep their caches; a request ends after
  ``max_tokens`` tokens.

Tokens are teacher-forced: every position is fed the token the port
served there, and the reference's logits at that position judge it. The
gap of a served token is the reference's best logit minus its logit for
that token (0 where the port chose as the reference would). A control
model run beside it in lockstep is judged by the token it puts first.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence

import numpy as np
import torch


class Lanes:
    """One model's caches and its prepared weights. On a card the decode
    step, whose shapes never change, is captured once in a CUDA graph and
    replayed: the same kernels on the same buffers, without the host's
    cost of issuing each."""

    def __init__(self, model, params, slots: int, ctx: int, device,
                 tf32: bool = False):
        self.model, self.params, self.tf32 = model, params, tf32
        with self._precision():
            self.prep = model.prepare(params)
        self.cache = model.init_cache(slots, ctx, device)
        self._graph = None

    def _precision(self):
        return _TF32(self.tf32)

    def prefill(self, toks, index, lens):
        with self._precision():
            return self.model.prefill(self.params, self.prep, toks,
                                      self.cache, index, lens)

    def decode(self, toks, index, active):
        with self._precision():
            if toks.device.type != "cuda":
                return self.model.decode(self.params, self.prep, toks,
                                         self.cache, index, active)
            if self._graph is None:
                self._capture(toks, index, active)
            for buf, t in zip(self._inputs, (toks, index, active)):
                buf.copy_(t)
            self._graph.replay()
            return self._out

    def _capture(self, toks, index, active):
        """Warm up and capture on inputs with every lane frozen, which
        leave the caches as they are."""
        inputs = [toks.clone(), index.clone(), torch.zeros_like(active)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                self.model.decode(self.params, self.prep, *inputs[:1],
                                  self.cache, *inputs[1:])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.model.decode(self.params, self.prep, inputs[0],
                                    self.cache, inputs[1], inputs[2])
        self._graph, self._inputs, self._out = graph, inputs, out


class _TF32:
    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def replay(models: Sequence[Lanes], traffic: Sequence[dict], served:
           Dict[int, List[int]], *, steps: int, clients: int, slots: int,
           max_ctx: int, bucket_min: int, bucket_max: int, budget: int,
           device) -> dict:
    """Replay ``steps`` scheduler steps of a closed loop over ``traffic``
    (dicts with ``prompt`` and ``max_tokens``) on ``models[0]`` (and a
    control, ``models[1]``, in lockstep), feeding the tokens ``served``
    (request index -> tokens). Returns, per request, the served tokens'
    gaps (and the control's), and the requests that finished."""
    b = slots
    lengths = np.zeros(b, np.int64)
    last = np.zeros(b, np.int64)
    active = np.zeros(b, bool)
    prefilling = np.zeros(b, bool)
    dirty = np.zeros(b, bool)
    emitted = np.zeros(b, np.int64)
    cap = np.zeros(b, np.int64)
    owner = np.full(b, -1, np.int64)
    pending: Dict[int, List[int]] = {}
    pending_logits: Dict[int, list] = {}
    waiting: deque = deque()
    in_prefill: List[int] = []
    running: Dict[int, int] = {}
    finished: List[int] = []
    gaps: List[tuple] = []          # (request, position, gap tensors)
    submitted = 0

    def tok(rid: int, k: int) -> int:
        got = served.get(rid, [])
        if k >= len(got):
            raise LookupError(f"request {rid} served {len(got)} tokens; "
                              f"the policy reaches token {k}")
        return got[k]

    def judge(rows, lane_rids, lane_pos):
        """Gaps of the served tokens at ``lane_pos`` of each judged lane."""
        ref = rows[0].float()
        lanes = list(lane_rids)
        idx = torch.tensor(lanes, device=device)
        served_ids = torch.tensor([tok(lane_rids[l], lane_pos[l])
                                   for l in lanes], device=device)
        best = ref[idx].amax(dim=-1)
        out = [best - ref[idx, served_ids]]
        if len(rows) > 1:
            top = rows[1].float()[idx].argmax(dim=-1)
            out.append(best - ref[idx, top])
        gaps.append(([lane_rids[l] for l in lanes], torch.stack(out)))

    def bucket(n: int) -> int:
        s = bucket_min
        while s < n:
            s *= 2
        return s

    for _ in range(steps):
        while submitted < len(traffic) and submitted - len(finished) \
                < clients:
            waiting.append(submitted)
            submitted += 1
        # admission
        free = int(np.sum(~active & ~prefilling))
        while waiting and free > 0:
            rid = waiting.popleft()
            slot = int(np.where(~active & ~prefilling)[0][0])
            if dirty[slot]:
                for m in models:
                    m.model.reset_lane(m.cache, slot)
            dirty[slot] = True
            lengths[slot] = 0
            prefilling[slot] = True
            pending[slot] = list(traffic[rid]["prompt"])
            emitted[slot] = 0
            cap[slot] = traffic[rid]["max_tokens"]
            owner[slot] = rid
            in_prefill.append(rid)
            free -= 1
        # prefill under the token budget
        spent = 0
        for rid in list(in_prefill):
            slot = int(np.where(owner == rid)[0][0])
            out_of_budget = False
            while pending[slot]:
                left = budget - spent
                if left <= 0:
                    out_of_budget = True
                    break
                take = min(len(pending[slot]), bucket_max, left)
                toks = np.zeros((b, bucket(take)), np.int64)
                toks[slot, :take] = pending[slot][:take]
                lens = np.zeros(b, np.int64)
                lens[slot] = take
                args = (torch.tensor(toks, device=device),
                        torch.tensor(lengths, device=device),
                        torch.tensor(lens, device=device))
                pending_logits[slot] = [m.prefill(*args) for m in models]
                del pending[slot][:take]
                lengths[slot] += take
                spent += take
            if out_of_budget:
                break
            rows = pending_logits.pop(slot)
            del pending[slot]
            judge(rows, {slot: rid}, {slot: 0})
            in_prefill.remove(rid)
            last[slot] = tok(rid, 0)
            prefilling[slot] = False
            emitted[slot] = 1
            if cap[slot] <= 1:
                finished.append(rid)
            else:
                active[slot] = True
                running[slot] = rid
        # one decode step of every lane
        if running:
            args = (torch.tensor(last[:, None], device=device),
                    torch.tensor(lengths, device=device),
                    torch.tensor(active, device=device))
            rows = [m.decode(*args) for m in models]
            act = np.where(active)[0]
            judge(rows, {int(s): running[int(s)] for s in act},
                  {int(s): int(emitted[s]) for s in act})
            for s in act:
                last[s] = tok(running[int(s)], int(emitted[s]))
            lengths[act] += 1
            emitted[act] += 1
            done = active & ((emitted >= cap) | (lengths >= max_ctx))
            for s in np.where(done)[0]:
                finished.append(running.pop(int(s)))
            active[done] = False

    per_request: Dict[int, list] = {}
    if gaps:
        host = torch.cat([g for _, g in gaps], dim=1).cpu().numpy()
        col = 0
        for rids, _ in gaps:
            for rid in rids:
                per_request.setdefault(rid, []).append(host[:, col])
                col += 1
    return {"finished": finished, "submitted": submitted,
            "gaps": {rid: np.stack(v, axis=1) for rid, v in
                     per_request.items()}}


def widest(result: dict) -> dict:
    """The widest gap over the tokens of the requests that finished (row
    0: the served tokens, row 1: the control's), and how many it covers."""
    cols = [result["gaps"][r] for r in result["finished"]
            if r in result["gaps"]]
    if not cols:
        return {"tokens": 0}
    g = np.concatenate(cols, axis=1)
    out = {"tokens": int(g.shape[1]), "served_gap": float(g[0].max())}
    if g.shape[0] > 1:
        out["control_gap"] = float(g[1].max())
    return out
