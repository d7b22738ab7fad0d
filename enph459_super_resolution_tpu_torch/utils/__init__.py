"""Utilities: typed configs, timing/tracing, plotting CLIs (the port's
counterpart of ``enph459_super_resolution_tpu/utils``)."""

from .config import apply_env, apply_overrides, from_dict, load, save, to_dict
from .timing import StageTimer
from .trace import MetricsLogger, device_trace

__all__ = [
    "apply_env", "apply_overrides", "from_dict", "load", "save", "to_dict",
    "StageTimer", "MetricsLogger", "device_trace",
]
