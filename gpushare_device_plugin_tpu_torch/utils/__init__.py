"""Observability of the pod: the metrics registry, the tracer and SLO
error budgets."""
