"""Config, metric logging, checkpoints and step timing."""

from .checkpoint import (
    restore_params,
    resume_training_state,
    save_checkpoint,
    save_state,
    save_training_state,
)
from .config import WorkloadConfig, add_common_args, parse_config
from .logging import MetricLogger
from .profiler import StepTimer
