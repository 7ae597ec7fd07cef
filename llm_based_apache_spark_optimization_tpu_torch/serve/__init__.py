"""Serving: prompt templates, the engine and scheduler backends, the
scheduler pool, the crash supervisor, the generation service and its QoS
front door, typed serving errors and the service assembly."""

from .backends import Completion, EngineBackend, FakeBackend, resolve_stop_ids  # noqa: F401
from .resilience import (  # noqa: F401
    CircuitOpen,
    DeadlineExceeded,
    Draining,
    Overloaded,
    SchedulerCrashed,
    SlotStalled,
)
from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    SchedulerBackend,
    SchedulerPool,
)
from .supervisor import SupervisedScheduler  # noqa: F401
from .service import GenerateResult, GenerationService  # noqa: F401
from .templates import TEMPLATES  # noqa: F401
