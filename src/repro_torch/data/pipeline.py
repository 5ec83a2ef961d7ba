"""Deterministic, resumable token pipeline; the port's counterpart of
``repro.data.pipeline``.

Every batch is a pure function of (seed, step), so a restarted job resumes
exactly from its checkpointed step with no data-state file. Two sources:

* ``SyntheticLM`` — Zipf-like tokens, ``min(u^-0.7 - 1, V - 1)`` for u
  uniform in [1e-6, 1) (the reference's law). ``jax.random`` cannot be
  reproduced, so u comes from the counter hash of ``serving.sampling``
  (``uniform``) under the key ``fold_in(fold_in(key(seed), step), row)``:
  the same bits on the CPU and the card, a batch for every (seed, step)
  whatever came before. Embedding inputs (``embedding_dim > 0``) are
  standard normals from two more such streams (Box-Muller).
* ``FileTokens`` — a memory-mapped flat token file, windows drawn by
  ``np.random.default_rng(seed + step)`` exactly as the reference draws
  them, so both packages read the same windows.

A batch holds ``inputs`` (B, S) int64 ids (or (B, S, D) f32 embeddings),
``labels`` (B, S), the inputs shifted by one, and a f32 loss ``mask``,
on the pipeline's device (None: the card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.serving import sampling

__all__ = ["DataConfig", "SyntheticLM", "FileTokens", "make_pipeline",
           "iterate"]

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | file
    path: Optional[str] = None
    embedding_dim: int = 0             # > 0: emit embeddings (modality stub)


class SyntheticLM:
    """Zipf-like tokens, a pure function of (seed, step)."""

    def __init__(self, cfg: DataConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _uniform(self, k: int, n: int) -> torch.Tensor:
        """(B, n) uniforms in (0, 1), row b keyed by ``fold_in(k, b)``."""
        keys = torch.tensor([sampling.fold_in(k, b) & _M32
                             for b in range(self.cfg.global_batch)],
                            dtype=torch.int64, device=self.device)
        return sampling.uniform(keys, n)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        k = sampling.fold_in(sampling.key(cfg.seed), step)
        u = 1e-6 + (1.0 - 1e-6) * self._uniform(k, cfg.seq_len + 1)
        toks = torch.clamp((u ** -0.7 - 1.0).to(torch.int64),
                           max=cfg.vocab_size - 1)
        batch = {"labels": toks[:, 1:],
                 "mask": torch.ones((cfg.global_batch, cfg.seq_len),
                                    dtype=torch.float32, device=self.device)}
        if cfg.embedding_dim:
            n = cfg.seq_len * cfg.embedding_dim
            u1 = self._uniform(sampling.fold_in(k, 1), n)
            u2 = self._uniform(sampling.fold_in(k, 2), n)
            z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
                2.0 * math.pi * u2)
            batch["inputs"] = z.reshape(cfg.global_batch, cfg.seq_len,
                                        cfg.embedding_dim)
        else:
            batch["inputs"] = toks[:, :-1]
        return batch


class FileTokens:
    """A flat uint16 / uint32 token file, windows drawn per step."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16,
                 device: Optional[Union[str, torch.device]] = None):
        if not cfg.path:
            raise ValueError("FileTokens needs cfg.path")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        n, span = cfg.global_batch, cfg.seq_len + 1
        rng = np.random.default_rng(cfg.seed + step)
        starts = rng.integers(0, len(self.data) - span, size=n)
        toks = np.stack([self.data[s:s + span] for s in starts]).astype(
            np.int64)
        toks = torch.tensor(np.minimum(toks, cfg.vocab_size - 1),
                            device=self.device)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:],
                "mask": torch.ones((n, cfg.seq_len), dtype=torch.float32,
                                   device=self.device)}


def make_pipeline(cfg: DataConfig,
                  device: Optional[Union[str, torch.device]] = None):
    return (FileTokens(cfg, device=device) if cfg.source == "file"
            else SyntheticLM(cfg, device=device))


def iterate(pipeline, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield pipeline.batch_at(step)
        step += 1
