"""The slot-pool and paged continuous-batching engines, their step
profiler, and the best-effort step governor of the interference plane."""

from .governor import StepGovernor  # noqa: F401
