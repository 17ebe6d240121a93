"""Shared node-resource parsing used by the inspect CLI and the extender.

Counterpart of ``gpushare_device_plugin_tpu/cluster/noderes.py``, copied
whole.

One definition of "per-chip capacity" so placement math and utilization
reports cannot diverge: total allocatable units split uniformly across the
advertised chip count (chips are homogeneous within a node on TPU-VMs).
"""

from __future__ import annotations


def chip_capacity_vector(node: dict, resource: str, count_resource: str) -> dict[int, int]:
    """chip index -> units, or {} when the node doesn't advertise ``resource``."""
    status = node.get("status", {})
    try:
        total = int(str(status.get("allocatable", {}).get(resource, "0")))
        chips = int(str(status.get("capacity", {}).get(count_resource, "0")))
    except ValueError:
        return {}
    if total <= 0:
        return {}
    if chips <= 0:
        chips = 1
    per = total // chips
    return {i: per for i in range(chips)}
