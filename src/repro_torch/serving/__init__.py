"""Serving for the port: the batched engine and its request types."""
from repro_torch.serving.engine import Engine, ServeConfig, StepResult
from repro_torch.serving.params import RequestOutput, SamplingParams

__all__ = ["Engine", "ServeConfig", "StepResult", "SamplingParams",
           "RequestOutput"]
