from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw_update, cosine_schedule, init_opt_state
from repro_torch.train.runner import FailurePlan, Runner, StragglerWatchdog
from repro_torch.train.train_loop import (
    batch_shardings, loss_fn, make_train_state, make_train_step,
    state_shardings,
)

__all__ = [
    "CheckpointManager", "adamw_update", "cosine_schedule", "init_opt_state",
    "FailurePlan", "Runner", "StragglerWatchdog", "batch_shardings",
    "loss_fn", "make_train_state", "make_train_step", "state_shardings",
]
