"""The slot-pool and paged continuous-batching engines, their step
profiler, the best-effort step governor of the interference plane,
disaggregated prefill/decode serving over a journaled KV handoff, and the
serving fleet: paged engines behind a prefix-affinity router with a
journaled scale-down."""

from .fleet import FleetServer  # noqa: F401
from .governor import StepGovernor  # noqa: F401
from .handoff import BrokenTransport, DisaggServer  # noqa: F401
