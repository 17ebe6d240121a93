"""Node-level apiserver interactions.

Counterpart of ``gpushare_device_plugin_tpu/cluster/node.py``, copied
whole.

Reference: ``patchGPUCount`` (``podmanager.go:74-99``) — advertise the
physical chip count on node status — and ``disableCGPUIsolationOrNot``
(``podmanager.go:59-72``) — a node label acting as a feature flag for the
cooperative HBM cap.
"""

from __future__ import annotations

from .. import const
from ..utils.log import get_logger
from .apiserver import ApiServerClient

log = get_logger("cluster.node")


def patch_chip_count(client: ApiServerClient, node_name: str, count: int) -> None:
    """Write ``aliyun.com/tpu-count`` into node capacity, skipping no-ops."""
    node = client.get_node(node_name)
    status = node.get("status", {})
    current = status.get("capacity", {}).get(const.RESOURCE_COUNT)
    if current is not None and str(current) == str(count):
        log.v(4, "node %s already advertises %s=%d", node_name, const.RESOURCE_COUNT, count)
        return
    client.patch_node_status(node_name, {const.RESOURCE_COUNT: str(count)})
    log.info("patched node %s: %s=%d", node_name, const.RESOURCE_COUNT, count)


def isolation_disabled(client: ApiServerClient, node_name: str) -> bool:
    """Node label ``ctpu.disable.isolation=true`` disables the HBM cap."""
    try:
        node = client.get_node(node_name)
    except Exception as e:
        log.warning("node label read failed (%s); keeping isolation on", e)
        return False
    labels = node.get("metadata", {}).get("labels") or {}
    return labels.get(const.LABEL_DISABLE_ISOLATION) == "true"
