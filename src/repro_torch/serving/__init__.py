"""Serving for the port: the batched engine, its request types and the
energy report."""
from repro_torch.serving.engine import (Engine, ServeConfig, StepResult,
                                       energy_report)
from repro_torch.serving.params import RequestOutput, SamplingParams

__all__ = ["Engine", "ServeConfig", "StepResult", "SamplingParams",
           "RequestOutput", "energy_report"]
