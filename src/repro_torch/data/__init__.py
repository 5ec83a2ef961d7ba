"""Input pipelines for training (``data.pipeline``)."""
from repro_torch.data.pipeline import (DataConfig, FileTokens, SyntheticLM,
                                       iterate, make_pipeline)

__all__ = ["DataConfig", "SyntheticLM", "FileTokens", "make_pipeline",
           "iterate"]
