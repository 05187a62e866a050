from .checkpoint import (CheckpointManager, save_checkpoint, load_checkpoint,
                         latest_step)
from .watchdog import StepWatchdog

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step", "StepWatchdog"]
