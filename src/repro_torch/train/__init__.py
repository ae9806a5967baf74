from repro_torch.train.step import TrainState, init_train_state, \
    make_train_step
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import train_loop, train_with_recovery
from repro_torch.train.fault import Watchdog, run_with_restarts

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "CheckpointManager", "train_loop", "train_with_recovery",
           "Watchdog", "run_with_restarts"]
