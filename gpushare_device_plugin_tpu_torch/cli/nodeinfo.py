"""Cluster share-utilization model for the inspect CLI.

Counterpart of ``gpushare_device_plugin_tpu/cli/nodeinfo.py`` (upstream:
``cmd/inspect/nodeinfo.go`` + ``podinfo.go``): shared nodes are those
advertising allocatable ``tpu-mem`` > 0; per-card usage is attributed from
the scheduler extender's per-container allocation annotation when present
(``GetAllocation``, ``nodeinfo.go:244-271``), else from the ``..._IDX``
annotation with the pod's summed limits; pods whose card cannot be
determined land in a "pending" bucket (devIdx -1, ``nodeinfo.go:136-139``).
The node's defrag status and interference verdicts come from its
annotations.
"""

from __future__ import annotations

import dataclasses
import json

from .. import const
from ..cluster import pods as P
from ..cluster.noderes import chip_capacity_vector
from ..topology import ChipTopology

PENDING_IDX = -1


@dataclasses.dataclass
class PodUsage:
    namespace: str
    name: str
    units_by_chip: dict[int, int]  # PENDING_IDX for unattributed
    # multi-chip gang grants: the granted slice shape ("2x2x1") and the
    # per-chip HBM share — the inspect CLI renders these with the member
    # chips' grid coordinates instead of a single device column
    gang_shape: str = ""
    gang_per_chip: int = 0
    # normalized QoS class (tpushare.aliyun.com/workload-class): the
    # interference plane's victim/aggressor split, rendered as a CLASS
    # column when any pod on the node is best-effort
    workload_class: str = const.WORKLOAD_LATENCY_CRITICAL
    # disaggregated-serving tier (tpushare.aliyun.com/serving-tier:
    # prefill/decode); "" for unified serving pods — the TIER column
    # appears only when some pod on the report declares one, preserving
    # the no-disagg reference layout
    serving_tier: str = ""

    @property
    def total_units(self) -> int:
        return sum(self.units_by_chip.values())

    @property
    def is_gang(self) -> bool:
        return bool(self.gang_shape) and len(self.units_by_chip) > 1


@dataclasses.dataclass
class DeviceInfo:
    index: int
    total_units: int
    used_units: int = 0


@dataclasses.dataclass
class CoreHold:
    """One tpu-core pod's exclusive chip hold (empty chips = not yet
    assigned: the hold is pending)."""

    namespace: str
    name: str
    chips: list[int]
    requested: int = 0


@dataclasses.dataclass
class NodeInfo:
    name: str
    address: str
    devices: dict[int, DeviceInfo]
    pods: list[PodUsage]
    pending_units: int = 0
    core_holds: list[CoreHold] = dataclasses.field(default_factory=list)
    # the node's chip grid (topology label or the default for its chip
    # count) — lets the report print gang member COORDINATES, not bare
    # indices
    topology: ChipTopology | None = None
    # the daemon's defrag-status annotation (allocator/defrag.py
    # DefragLoop.publish_status): move counters + stranded totals; None
    # when the node runs no defragmenter (columns stay hidden, keeping
    # the reference layout)
    defrag: dict | None = None
    # per-chip stranded-HBM units, recomputed from this report's own
    # usage attribution at the annotation's quantum
    stranded_by_chip: dict[int, int] = dataclasses.field(default_factory=dict)
    # the interference detector's node annotation (cluster/interference.py
    # interference_from_node): per-chip victim/aggressor/ratio verdicts;
    # None when the node runs no detector (rendering stays hidden)
    interference: dict | None = None

    @property
    def total_units(self) -> int:
        return sum(d.total_units for d in self.devices.values())

    @property
    def used_units(self) -> int:
        return sum(d.used_units for d in self.devices.values())

    @property
    def core_held_chips(self) -> list[int]:
        return sorted({i for h in self.core_holds for i in h.chips})


def is_shared_tpu_node(node: dict) -> bool:
    """Allocatable ``aliyun.com/tpu-mem`` > 0 (``podinfo.go:213-221``)."""
    try:
        alloc = node.get("status", {}).get("allocatable", {})
        return int(str(alloc.get(const.RESOURCE_MEM, "0"))) > 0
    except ValueError:
        return False


def node_address(node: dict) -> str:
    for addr in node.get("status", {}).get("addresses", []) or []:
        if addr.get("type") == "InternalIP":
            return addr.get("address", "")
    return ""


def pod_allocation(pod: dict) -> dict[int, int]:
    """Per-chip units for one pod.

    Priority 1: extender annotation (JSON ``{container: {chipIdx: units}}``,
    ``nodeinfo.go:244-271``). Priority 2: IDX annotation x summed limits.
    Fallback: everything pending.
    """
    ann = P.annotations(pod)
    gang = P.gang_usage_by_chip(pod)
    if gang:
        # multi-chip gang: the persisted member set IS the per-chip truth
        return dict(gang)
    raw = ann.get(const.ANN_EXTENDER_ALLOCATION)
    if raw:
        try:
            per_container = json.loads(raw)
            out: dict[int, int] = {}
            for chip_map in per_container.values():
                for idx_str, units in chip_map.items():
                    idx = int(idx_str)
                    out[idx] = out.get(idx, 0) + int(units)
            if out:
                return out
        except (ValueError, AttributeError, TypeError):
            pass  # garbled annotation: fall through to IDX
    total = P.mem_units_of_pod(pod)
    if total <= 0:
        return {}
    idx = P.chip_idx_from_annotation(pod)
    if idx < 0 or not P.is_assigned(pod):
        return {PENDING_IDX: total}
    return {idx: total}


def build_node_info(
    node: dict, pods: list[dict], core_pods: list[dict] | None = None
) -> NodeInfo:
    """Pods must already be filtered to this node's active share pods;
    ``core_pods`` to its active whole-chip (tpu-core) pods."""
    capacity = chip_capacity_vector(node, const.RESOURCE_MEM, const.RESOURCE_COUNT)
    topo = ChipTopology.from_node(node, len(capacity)) if capacity else None
    info = NodeInfo(
        name=node.get("metadata", {}).get("name", ""),
        address=node_address(node),
        devices={
            i: DeviceInfo(index=i, total_units=per) for i, per in capacity.items()
        },
        pods=[],
        topology=topo,
    )
    for pod in pods:
        usage = pod_allocation(pod)
        if not usage:
            continue
        info.pods.append(
            PodUsage(
                namespace=P.namespace(pod),
                name=P.name(pod),
                units_by_chip=usage,
                gang_shape=P.annotations(pod).get(const.ENV_GANG_SHAPE, ""),
                gang_per_chip=P.gang_per_chip_units(pod),
                workload_class=P.workload_class(pod),
                serving_tier=P.serving_tier(pod),
            )
        )
        for idx, units in usage.items():
            if idx == PENDING_IDX:
                info.pending_units += units
            elif idx in info.devices:
                info.devices[idx].used_units += units
            else:
                # annotation points at a chip the node doesn't advertise
                info.devices[idx] = DeviceInfo(
                    index=idx, total_units=0, used_units=units
                )
    for pod in core_pods or []:
        info.core_holds.append(
            CoreHold(
                namespace=P.namespace(pod),
                name=P.name(pod),
                chips=P.core_hold_chips(pod) if P.is_assigned(pod) else [],
                requested=P.core_chips_of_pod(pod),
            )
        )
    # Defrag status (when the node's daemon publishes it): the MOVES
    # column straight from the annotation, per-chip stranded slivers
    # recomputed from THIS report's usage attribution at the published
    # quantum — so the table's chips and its stranded markers can never
    # disagree with each other.
    from ..allocator.defrag import status_from_node, stranded_units

    info.defrag = status_from_node(node)
    if info.defrag is not None:
        info.stranded_by_chip = stranded_units(
            {i: d.total_units for i, d in info.devices.items()},
            {i: d.used_units for i, d in info.devices.items()},
            int(info.defrag.get("quantum") or 0),
        )
    # Interference verdicts (when the node's daemon runs the detector):
    # per-chip victim/aggressor/ratio straight from the annotation.
    from ..cluster.interference import interference_from_node

    info.interference = interference_from_node(node)
    return info


def build_all_node_infos(nodes: list[dict], pods: list[dict]) -> list[NodeInfo]:
    """Shared nodes only; active (not Succeeded/Failed) share pods grouped
    by node (``buildAllNodeInfos``, ``nodeinfo.go:46-93``)."""
    infos = []
    for node in nodes:
        if not is_shared_tpu_node(node):
            continue
        name = node.get("metadata", {}).get("name", "")
        active = [
            p
            for p in pods
            if P.node_name(p) == name and P.phase(p) not in ("Succeeded", "Failed")
        ]
        node_pods = [p for p in active if P.mem_units_of_pod(p) > 0]
        core_pods = [p for p in active if P.core_chips_of_pod(p) > 0]
        infos.append(build_node_info(node, node_pods, core_pods))
    return infos


def infer_unit(infos: list[NodeInfo]) -> str:
    """Heuristic from the reference (``setUnit``, ``nodeinfo.go:227-243``):
    per-chip capacity > 100 reads as MiB, else GiB."""
    for info in infos:
        for dev in info.devices.values():
            if dev.total_units > 100:
                return "MiB"
            if dev.total_units > 0:
                return "GiB"
    return "GiB"
