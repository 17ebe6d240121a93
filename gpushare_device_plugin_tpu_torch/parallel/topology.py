"""The gang-shape wire format, as the plugin writes it into a pod's env.

Counterpart of ``gpushare_device_plugin_tpu/topology/model.py::parse_shape``
(the one parser every consumer of a shape string uses), copied so the port
imports nothing of the reference package.
"""

from __future__ import annotations

MAX_DIMS = 3


def parse_shape(raw: str) -> tuple[int, ...]:
    """``"2x2x1"`` -> ``(2, 2, 1)``; a bare count ``"4"`` -> ``(4,)``.
    Raises ``ValueError`` on anything else: empty, a non-integer or
    non-positive dim, more than three axes."""
    parts = [p.strip() for p in str(raw).lower().split("x")]
    if not parts or len(parts) > MAX_DIMS:
        raise ValueError(f"invalid gang shape {raw!r}: expected up to 3 'x'-separated dims")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"invalid gang shape {raw!r}: non-integer dim") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"invalid gang shape {raw!r}: dims must be >= 1")
    return dims
