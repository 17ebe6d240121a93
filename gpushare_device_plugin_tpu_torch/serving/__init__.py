"""The slot-pool and paged continuous-batching engines, their step
profiler, the best-effort step governor of the interference plane, and
disaggregated prefill/decode serving over a journaled KV handoff."""

from .governor import StepGovernor  # noqa: F401
from .handoff import BrokenTransport, DisaggServer  # noqa: F401
