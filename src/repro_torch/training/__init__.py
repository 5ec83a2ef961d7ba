"""Training for the port: the optimizer (AdamW / Adafactor, int8
error-feedback compression), the train step and the resilient loop,
atomic two-tier asynchronous checkpoints, and heartbeat-based failure and
straggler detection. The reference's fault-drill supervisor, elastic
re-meshing and fault plans come with the parallel slice."""
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.fault import (Heartbeat, HeartbeatBoard,
                                        detect_failures, detect_stragglers)
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import TrainConfig, make_train_step, train

__all__ = [
    "AsyncCheckpointer", "latest_step", "restore_checkpoint",
    "save_checkpoint", "Heartbeat", "HeartbeatBoard", "detect_failures",
    "detect_stragglers", "OptimizerConfig", "TrainConfig", "make_train_step",
    "train",
]
