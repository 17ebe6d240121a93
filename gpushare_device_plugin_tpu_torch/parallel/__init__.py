"""Attention math shared across the port (single-device part of ``parallel``)."""
