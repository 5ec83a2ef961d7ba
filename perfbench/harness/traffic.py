"""The one general generator: a traffic mix file (``traffic/<name>.json``)
holds parameters, and these functions turn them and ``--seed`` into the
inputs both sides are given.

Closed-loop requests: prompt and output lengths each follow an
exponential law with the mean the mix cites (``prompt_mean``,
``output_mean``), cut as the mix's source cuts them (each at least
``min_len``, a prompt at most ``prompt_max``, the two together at most
``total_max``: an output at most ``total_max`` less the longest prompt); token ids are uniform over [1, vocab). So that every seed
asks for the same work in another order, each block of ``block``
consecutive requests takes its prompt lengths from the ``block``
midpoint quantiles of the prompt law and its output lengths from those
of the output law, each list in an order of its own drawn from the seed:
a prompt's length says nothing of its output's.

Training batches: Zipf-like token ids, min(u^-0.7 - 1, vocab - 1) for u
uniform in [1e-6, 1) (the law of the port's ``data.pipeline.SyntheticLM``),
u drawn by a generator on the device keyed by (seed, step), so every row
of every step differs and a step's batch does not depend on the others.
"""
from __future__ import annotations

import numpy as np
import torch


def quantiles(mean: float, n: int) -> np.ndarray:
    """The lengths at the midpoints of n equal slices of probability of the
    exponential law with mean ``mean``, rounded to whole tokens."""
    u = (np.arange(n) + 0.5) / n
    return np.rint(-mean * np.log1p(-u)).astype(np.int64)


def closed_loop_requests(mix: dict, vocab: int, seed: int) -> list:
    """``mix["requests"]`` dicts {"prompt": [ids], "max_tokens": n}."""
    rng = np.random.default_rng(int(seed))
    n, least = mix["block"], mix["min_len"]
    plen = np.clip(quantiles(mix["prompt_mean"], n), least,
                   mix["prompt_max"])
    # the longest output fits beside the longest prompt, so that every
    # pairing keeps to ``total_max`` with the same lengths
    olen = np.clip(quantiles(mix["output_mean"], n), least,
                   mix["total_max"] - plen.max())
    out = []
    while len(out) < mix["requests"]:
        for p, o in zip(rng.permutation(plen), rng.permutation(olen)):
            out.append({"prompt": rng.integers(1, vocab, int(p)).tolist(),
                        "max_tokens": int(o)})
    return out[:mix["requests"]]


def train_batch(mix: dict, vocab: int, seed: int, step: int, device) -> dict:
    """{"inputs", "labels": (B, S) int64, "mask": (B, S) float32} of one
    step."""
    b, s = mix["batch"], mix["seq_len"]
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (1 << 63))
    u = 1e-6 + (1.0 - 1e-6) * torch.rand((b, s + 1), generator=gen,
                                         device=device)
    toks = torch.clamp((u ** -0.7 - 1.0).to(torch.int64), max=vocab - 1)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:],
            "mask": torch.ones((b, s), dtype=torch.float32, device=device)}
