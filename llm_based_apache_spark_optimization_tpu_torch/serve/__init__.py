"""Serving: prompt templates, the engine and scheduler backends and the
generation service."""

from .backends import Completion, EngineBackend, resolve_stop_ids  # noqa: F401
from .resilience import SchedulerCrashed  # noqa: F401
from .scheduler import ContinuousBatchingScheduler, SchedulerBackend  # noqa: F401
from .service import GenerateResult, GenerationService  # noqa: F401
from .templates import TEMPLATES  # noqa: F401
