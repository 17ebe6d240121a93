"""Pure memory binpack policy.

Counterpart of ``gpushare_device_plugin_tpu/allocator/binpack.py``,
copied. Upstream's ``assignDevice`` is first-fit over ascending card index
(``server.go:249-264``) against the availability vector of
``getAvailableGPUs``: per-card capacity minus the usage running pods
declare (``server.go:268-289``). Kept pure (no I/O) so it stays
table-testable.

Beyond upstream:
- ``policy="best-fit"``: the feasible chip with the least free space,
  which improves worst-case fragmentation for mixed request sizes.
- ``policy="spread"``: the feasible chip with the MOST free space, the
  anti-affinity choice for latency-sensitive fleets (ties break to the
  lowest index, so it stays deterministic).
- unhealthy chips are excluded (upstream's TODO at ``server.go:267``).
"""

from __future__ import annotations

from typing import Mapping, Sequence


class AssignmentError(RuntimeError):
    """No chip has enough free memory units for the request."""


def available_units(
    capacity: Mapping[int, int],
    used: Mapping[int, int],
    unhealthy: Sequence[int] = (),
) -> dict[int, int]:
    """Free units per chip index: capacity - used, unhealthy chips removed.

    ``used`` entries for unknown or out-of-range chip indices are ignored
    (defensive: annotations are client-writable).
    """
    avail: dict[int, int] = {}
    bad = set(unhealthy)
    for idx in sorted(capacity):
        if idx in bad:
            continue
        avail[idx] = max(0, capacity[idx] - used.get(idx, 0))
    return avail


def assign_chip(
    request_units: int,
    capacity: Mapping[int, int],
    used: Mapping[int, int],
    unhealthy: Sequence[int] = (),
    policy: str = "first-fit",
) -> int:
    """Pick the chip index to host a request of ``request_units``.

    Raises ``AssignmentError`` when nothing fits (the caller turns this into
    a gRPC error -> kubelet UnexpectedAdmissionError, ``allocate.go:99-105``).
    """
    if request_units <= 0:
        raise AssignmentError(f"invalid request of {request_units} units")
    avail = available_units(capacity, used, unhealthy)
    if policy == "first-fit":
        # ascending chip index, first chip that fits (server.go:250-264)
        for idx in sorted(avail):
            if avail[idx] >= request_units:
                return idx
    elif policy in ("best-fit", "spread"):
        # best-fit: least free space among feasible chips (densest packing);
        # spread: most free space (least contention). Ties -> lowest index.
        prefer_less = policy == "best-fit"
        best = None
        for idx in sorted(avail):
            if avail[idx] >= request_units:
                if best is None or (
                    avail[idx] < avail[best]
                    if prefer_less
                    else avail[idx] > avail[best]
                ):
                    best = idx
        if best is not None:
            return best
    else:
        raise ValueError(f"unknown binpack policy {policy!r}")
    raise AssignmentError(
        f"no chip can fit {request_units} units (available: {avail})"
    )
