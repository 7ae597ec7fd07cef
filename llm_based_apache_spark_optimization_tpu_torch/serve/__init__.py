"""Serving: prompt templates, the engine and scheduler backends, the crash
supervisor, the generation service, typed serving errors and the
reference-app assembly."""

from .backends import Completion, EngineBackend, FakeBackend, resolve_stop_ids  # noqa: F401
from .resilience import (  # noqa: F401
    CircuitOpen,
    DeadlineExceeded,
    Draining,
    Overloaded,
    SchedulerCrashed,
)
from .scheduler import ContinuousBatchingScheduler, SchedulerBackend  # noqa: F401
from .supervisor import SupervisedScheduler  # noqa: F401
from .service import GenerateResult, GenerationService  # noqa: F401
from .templates import TEMPLATES  # noqa: F401
