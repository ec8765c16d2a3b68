from .progress import ProgressReporter, StdoutReporter, NullReporter
from .profiling import PhaseTimer, device_trace

__all__ = [
    "ProgressReporter",
    "StdoutReporter",
    "NullReporter",
    "PhaseTimer",
    "device_trace",
]
