"""The gang-shape wire format, as the plugin writes it into a pod's env.

Counterpart of ``gpushare_device_plugin_tpu/topology/model.py``'s
``parse_shape`` (the one parser every consumer of a shape string uses),
``format_shape`` and ``pad3`` (the gang env's writer), copied so the port
imports nothing of the reference package.
"""

from __future__ import annotations

from typing import Sequence

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


def format_shape(dims: Sequence[int]) -> str:
    """``(2, 2, 1)`` -> ``"2x2x1"``, the inverse of :func:`parse_shape`."""
    return "x".join(str(d) for d in dims)


def pad3(dims: Sequence[int]) -> tuple[int, int, int]:
    """Pad a 1-3 dim shape to the canonical (x, y, z) form: the padding
    rule the plugin's gang env uses for its shape and its carve-out."""
    d = tuple(dims) + (1,) * (MAX_DIMS - len(dims))
    return d[0], d[1], d[2]
