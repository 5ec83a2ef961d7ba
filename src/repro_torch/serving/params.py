"""Request-level serving API types: ``SamplingParams`` and
``RequestOutput`` (copies of ``repro.serving.params``).

``SamplingParams`` is the way per-request knobs enter
``Engine.add_request``/``begin_request`` and ``Scheduler.submit``. Every
field defaults to "inherit the engine default", so ``SamplingParams()``
is always a valid no-op:

* ``temperature`` — per-request sampling temperature; ``None`` inherits
  ``ServeConfig.temperature``. ``0.0`` forces greedy argmax for this
  request even inside a sampled batch (selection is per lane).
* ``seed`` — per-request sampling seed. A seeded request draws its lane
  key as ``fold_in(key(seed), event_counter)`` (``serving.sampling``), so
  its sampled stream is the same whatever slot it lands in, whatever keys
  the caller passes and whatever traffic shares the batch; it samples
  even when the caller passes no key (unseeded lanes draw from the
  caller's per-step key).
* ``eos_id`` — per-request stop token; ``None`` inherits
  ``ServeConfig.eos_id``.
* ``max_tokens`` — cap on *generated* tokens (including the
  prefill-selected first one). The lane is freed with finish reason
  ``"length"`` the step it reaches the cap. ``None`` decodes until EOS /
  context exhaustion.
* ``spec_k`` — speculative-decode lookahead: speculative decode not
  ported yet (ROADMAP item 8c); ignored by ``Engine.step``.

``RequestOutput`` is the typed per-request slice of a decode iteration;
``StepResult.outputs`` carries one per live request: the tokens emitted
this step, whether the request finished and why (``"eos"`` /
``"length"`` / ``"ctx"``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["SamplingParams", "RequestOutput"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: Optional[float] = None
    seed: Optional[int] = None
    eos_id: Optional[int] = None
    max_tokens: Optional[int] = None
    spec_k: Optional[int] = None

    def __post_init__(self):
        if self.temperature is not None and self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got "
                             f"{self.max_tokens}")
        if self.spec_k is not None and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")

    def replace(self, **kw) -> "SamplingParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class RequestOutput:
    """One request's slice of a decode iteration (``StepResult.outputs``).

    ``tokens`` are the tokens emitted this step in order (empty for a
    completion surfaced from prefill time); ``finished``/``finish_reason``
    report terminal state (``"eos"`` / ``"length"`` / ``"ctx"``);
    ``pj_per_token`` is the decode-phase CIM energy per generated token
    (``Engine.energy_per_token``, resolved on first read; None when the
    arch serves without the CIM path)."""
    slot: int
    tokens: List[int]
    finished: bool = False
    finish_reason: Optional[str] = None
    _energy_fn: Optional[callable] = None

    @property
    def pj_per_token(self) -> Optional[float]:
        return self._energy_fn() if self._energy_fn is not None else None
