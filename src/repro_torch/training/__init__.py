"""Training for the port: the optimizer (AdamW / Adafactor, int8
error-feedback compression), the train step and the resilient loop,
atomic two-tier asynchronous checkpoints, heartbeat-based failure and
straggler detection, elastic re-meshing and fault plans, and the
supervised fault drill with its GoodPut ledger (``supervisor``)."""
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.fault import (FAULT_KINDS, FaultEvent, FaultPlan,
                                        Heartbeat, HeartbeatBoard,
                                        detect_failures, detect_stragglers,
                                        make_fault_plan, plan_remesh,
                                        reshard_tree)
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.supervisor import (DrillConfig, GoodPutLedger,
                                             SimFleet, Supervisor,
                                             price_drill)
from repro_torch.training.trainer import TrainConfig, make_train_step, train

__all__ = [
    "AsyncCheckpointer", "latest_step", "restore_checkpoint",
    "save_checkpoint", "FAULT_KINDS", "FaultEvent", "FaultPlan", "Heartbeat",
    "HeartbeatBoard", "detect_failures", "detect_stragglers",
    "make_fault_plan", "plan_remesh", "reshard_tree", "OptimizerConfig",
    "DrillConfig", "GoodPutLedger", "SimFleet", "Supervisor", "price_drill",
    "TrainConfig", "make_train_step", "train",
]
