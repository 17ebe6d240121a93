"""Observability and the protocol layer: the metrics registry, the tracer,
SLO error budgets, the journal's helpers, and the node agent's flight
recorder, timeline ring and stack dumps."""
