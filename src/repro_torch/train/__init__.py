from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import adamw_update, cosine_schedule, init_opt_state
from repro_torch.train.runner import FailurePlan, Runner, StragglerWatchdog
from repro_torch.train.train_loop import (
    loss_fn, make_train_state, make_train_step,
)

# the reference's __all__ without batch_shardings and state_shardings,
# which have no one-card counterpart (ROADMAP: distribution)
__all__ = [
    "CheckpointManager", "adamw_update", "cosine_schedule", "init_opt_state",
    "FailurePlan", "Runner", "StragglerWatchdog",
    "loss_fn", "make_train_state", "make_train_step",
]
