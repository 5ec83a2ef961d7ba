"""Serving for the port: the slot ``Engine``, the ``PrefixCache`` beside
it and the continuous-batching ``Scheduler`` above both, with the request
types, the per-lane sampler (``serving.sampling``), self-speculative
decode (``serving.speculative``) and the energy report."""
from repro_torch.serving.engine import (Engine, ServeConfig, StepResult,
                                       energy_report)
from repro_torch.serving.params import RequestOutput, SamplingParams
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import (
    Request,
    Scheduler,
    SchedulerConfig,
    StaticBatchScheduler,
    StepClock,
    run_closed_loop,
    run_open_loop,
    synth_shared_prefix_traffic,
    synth_traffic,
)
from repro_torch.serving.speculative import (SpecConfig, SpecDecoder,
                                             draft_arch_for,
                                             price_speculation)

__all__ = [
    "Engine", "ServeConfig", "StepResult", "energy_report", "PrefixCache",
    "RequestOutput", "SamplingParams",
    "Request", "Scheduler", "SchedulerConfig", "StaticBatchScheduler",
    "StepClock", "run_open_loop", "run_closed_loop", "synth_traffic",
    "synth_shared_prefix_traffic", "SpecConfig", "SpecDecoder",
    "draft_arch_for", "price_speculation",
]
