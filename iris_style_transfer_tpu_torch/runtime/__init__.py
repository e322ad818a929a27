"""Config, metric logging, checkpoint restore and step timing."""

from .checkpoint import restore_params
from .config import WorkloadConfig, add_common_args, parse_config
from .logging import MetricLogger
from .profiler import StepTimer
