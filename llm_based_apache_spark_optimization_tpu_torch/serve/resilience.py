"""Typed serving errors (a copy of the JAX package's `serve/resilience.py`
error the scheduler core raises; its deadlines, retry policy and circuit
breakers are not ported yet)."""

from __future__ import annotations


class SchedulerCrashed(RuntimeError):
    """The scheduler's event loop died: every request on it fails with THIS
    (not a per-request error), carrying the original traceback so callers
    can answer "engine dead" instead of a generic failure."""

    def __init__(self, message: str, crash_traceback: str = ""):
        super().__init__(message)
        self.crash_traceback = crash_traceback

    @classmethod
    def from_exception(cls, exc: BaseException) -> "SchedulerCrashed":
        import traceback

        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        wrapped = cls(f"scheduler loop crashed: {exc!r}", crash_traceback=tb)
        wrapped.__cause__ = exc
        return wrapped
