"""Pod-state predicates and accessors over k8s pod JSON.

Counterpart of ``gpushare_device_plugin_tpu/cluster/pods.py``, copied
whole.

Pure functions over the JSON wire form of ``v1.Pod`` (we use no kubernetes
client library; both the apiserver and kubelet clients hand back parsed
JSON). Mirrors the reference's ``podutils.go:38-136`` predicates and the
candidate/used-memory accounting in ``podmanager.go:102-293``.

Pod lifecycle as seen by the plugin (the "apiserver is the database" state
machine):

  Pending ──(extender assumes: writes IDX + ASSUME_TIME)──▶ assumed
  Pending/assumed ──(Allocate(): writes ASSIGNED=true ...)──▶ assigned
  Running(label tpu/resource=tpu-mem + IDX annotation) ──▶ counted as usage
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

from .. import const

Pod = Mapping[str, Any]  # parsed v1.Pod JSON


# --- metadata accessors ----------------------------------------------------


def name(pod: Pod) -> str:
    return pod.get("metadata", {}).get("name", "")


def namespace(pod: Pod) -> str:
    return pod.get("metadata", {}).get("namespace", "default")


def uid(pod: Pod) -> str:
    return pod.get("metadata", {}).get("uid", "")


def annotations(pod: Pod) -> Mapping[str, str]:
    return pod.get("metadata", {}).get("annotations") or {}


def labels(pod: Pod) -> Mapping[str, str]:
    return pod.get("metadata", {}).get("labels") or {}


def node_name(pod: Pod) -> str:
    return pod.get("spec", {}).get("nodeName", "")


def phase(pod: Pod) -> str:
    return pod.get("status", {}).get("phase", "")


def creation_timestamp(pod: Pod) -> str:
    # RFC3339 strings sort lexicographically in time order
    return pod.get("metadata", {}).get("creationTimestamp", "")


def sort_key_by_creation(pod: Pod) -> tuple[str, str, str]:
    """Oldest first; name/namespace tiebreak for determinism.

    The reference sorts by CreationTimestamp only (``podmanager.go:281-293``)
    which leaves same-instant pods in arbitrary order — one of the two sides
    of the documented allocation race (SURVEY.md section 3.2); the tiebreak
    removes the nondeterminism on our side.
    """
    return (creation_timestamp(pod), namespace(pod), name(pod))


# --- resource accounting ---------------------------------------------------


def _quantity(v: Any) -> int:
    """Parse an extended-resource quantity (always a bare integer)."""
    try:
        return int(str(v))
    except (TypeError, ValueError):
        return 0


def mem_units_of_container(container: Mapping[str, Any], resource: str = const.RESOURCE_MEM) -> int:
    limits = container.get("resources", {}).get("limits") or {}
    return _quantity(limits.get(resource))


def mem_units_of_pod(pod: Pod, resource: str = const.RESOURCE_MEM) -> int:
    """Sum of ``aliyun.com/tpu-mem`` container *limits* (``podutils.go:127-136``)."""
    return sum(
        mem_units_of_container(c, resource)
        for c in pod.get("spec", {}).get("containers", [])
    )


def core_chips_of_pod(pod: Pod) -> int:
    return mem_units_of_pod(pod, resource=const.RESOURCE_CORE)


# --- share-pod state predicates (podutils.go:84-124) -----------------------


def is_tpu_share_pod(pod: Pod) -> bool:
    return mem_units_of_pod(pod) > 0


def is_tpu_core_pod(pod: Pod) -> bool:
    return core_chips_of_pod(pod) > 0


def is_assumed(pod: Pod) -> bool:
    """The scheduler extender wrote an assume-time annotation."""
    return const.ENV_ASSUME_TIME in annotations(pod)


def is_assigned(pod: Pod) -> bool:
    """Plugin has completed Allocate() for this pod.

    Reference semantics (``podutils.go:108-124``): the annotation must be
    present AND not literally "false".
    """
    v = annotations(pod).get(const.ENV_ASSIGNED_FLAG)
    return v is not None and v != "false"


def chip_idx_from_annotation(pod: Pod) -> int:
    """Assigned chip index, -1 when absent/garbled (``podutils.go:38-62``)."""
    v = annotations(pod).get(const.ENV_MEM_IDX)
    if v is None:
        return -1
    try:
        return int(v)
    except ValueError:
        return -1


def core_ids_from_annotation(pod: Pod) -> list[int]:
    """Chip indices exclusively held by this pod (``ENV_CORE_IDS``), []
    when absent/garbled."""
    v = annotations(pod).get(const.ENV_CORE_IDS)
    if not v:
        return []
    out: list[int] = []
    for part in str(v).split(","):
        try:
            out.append(int(part))
        except ValueError:
            return []
    return out


def gang_shape_request(pod: Pod) -> str:
    """The gang shape this pod ASKS for (``ANN_GANG_SHAPE`` on its spec:
    "2x2x1" or a bare count "4"), "" for ordinary single-chip pods. The
    request annotation is user-written; validity is checked where it is
    consumed (extender filter, allocator placement)."""
    return str(annotations(pod).get(const.ANN_GANG_SHAPE, "") or "")


def is_gang_pod(pod: Pod) -> bool:
    return bool(gang_shape_request(pod)) and mem_units_of_pod(pod) > 0


def gang_group(pod: Pod) -> str:
    """The pod's gang-GROUP id (``ANN_GANG_GROUP``), "" for pods that
    are not members of a cross-node group. Members of one group are
    admitted all-or-nothing through the sharded extender's two-phase
    reserve (extender/shards.py)."""
    return str(annotations(pod).get(const.ANN_GANG_GROUP, "") or "")


def serving_tier(pod: Pod) -> str:
    """The pod's disaggregated-serving tier (``ANN_SERVING_TIER``:
    "prefill" or "decode"), "" for unified serving pods or unknown
    values. One helper so group admission, the inspect CLI's TIER
    column, and `inspect why`'s two-tier composition can never disagree
    about which side of the KV handoff a member serves."""
    v = str(annotations(pod).get(const.ANN_SERVING_TIER, "") or "").strip()
    return v if v in const.SERVING_TIERS else ""


def gang_chips_from_annotation(pod: Pod) -> list[int]:
    """Member chip indices of a GRANTED gang (``ENV_GANG_CHIPS``), [] when
    absent/garbled — same tolerance as ``core_ids_from_annotation``."""
    v = annotations(pod).get(const.ENV_GANG_CHIPS)
    if not v:
        return []
    out: list[int] = []
    for part in str(v).split(","):
        try:
            out.append(int(part))
        except ValueError:
            return []
    return sorted(out)


def gang_per_chip_units(pod: Pod) -> int:
    """HBM units this gang claims on EACH member chip. Derived from the
    IMMUTABLE spec (total limits / member count) whenever it divides —
    the same tamper-resistance rule the single-chip audit gets from
    counting ``mem_units_of_pod``: an edited ``ENV_GANG_PER_CHIP``
    annotation must not shrink what every accounting layer books. The
    persisted annotation is only the fallback for annotation sets whose
    spec-derivation is impossible. 0 when underivable."""
    chips = gang_chips_from_annotation(pod)
    total = mem_units_of_pod(pod)
    if chips and total > 0 and total % len(chips) == 0:
        return total // len(chips)
    v = annotations(pod).get(const.ENV_GANG_PER_CHIP)
    if v is not None:
        try:
            per = int(v)
            return per if per > 0 else 0
        except ValueError:
            return 0
    return 0


def gang_usage_by_chip(pod: Pod) -> dict[int, int]:
    """Per-chip HBM units one granted gang pod holds ({} when the pod is
    not an annotated gang). One helper so the allocator overlay, the
    extender index, the reconciler audit, and the inspect CLI can never
    disagree about what a gang holds."""
    chips = gang_chips_from_annotation(pod)
    if not chips:
        return {}
    per = gang_per_chip_units(pod)
    if per <= 0:
        return {}
    return {idx: per for idx in chips}


def workload_class(pod: Pod) -> str:
    """The pod's declared QoS class (``ANN_WORKLOAD_CLASS``), normalized.

    Absent or garbled values read as ``latency-critical`` — the safe
    default is to protect a tenant, never to throttle one that forgot to
    label itself. One helper so admission, the informer indexes, the
    interference detector, and the inspect CLI can never disagree about
    a pod's class."""
    v = str(annotations(pod).get(const.ANN_WORKLOAD_CLASS, "") or "").strip()
    if v in const.WORKLOAD_CLASSES:
        return v
    return const.WORKLOAD_LATENCY_CRITICAL


def is_best_effort(pod: Pod) -> bool:
    return workload_class(pod) == const.WORKLOAD_BEST_EFFORT


def lora_adapter(pod: Pod) -> str:
    """The pod's requested LoRA adapter id (``ANN_LORA_ADAPTER``),
    stripped; empty string means the base model. One helper so the
    decision PATCH, the env injection, and the inspect CLI can never
    disagree about which adapter a pod asked for."""
    return str(annotations(pod).get(const.ANN_LORA_ADAPTER, "") or "").strip()


def assume_time_from_annotation(pod: Pod) -> int:
    v = annotations(pod).get(const.ENV_ASSUME_TIME)
    try:
        return int(v) if v is not None else 0
    except ValueError:
        return 0


# --- aggregate views -------------------------------------------------------


def candidate_pods(
    pods: Iterable[Pod], this_node: str, resource: str = const.RESOURCE_MEM
) -> list[Pod]:
    """Pending pods on this node requesting ``resource``, awaiting
    Allocate, oldest first.

    Reference: ``getCandidatePods`` (``podmanager.go:247-269``) — tpushare
    pods that are not yet (assumed AND assigned); pods scheduled to other
    nodes are skipped; duplicates (by UID) dropped.
    """
    seen: set[str] = set()
    out: list[Pod] = []
    for pod in pods:
        # Unscheduled pods (empty nodeName) are never candidates: Allocate
        # runs only after kubelet admitted the pod to *this* node
        # (reference warns+skips on mismatch, podmanager.go:200-205).
        if node_name(pod) != this_node:
            continue
        if uid(pod) in seen:
            continue
        seen.add(uid(pod))
        if mem_units_of_pod(pod, resource) <= 0:
            continue
        if is_assumed(pod) and is_assigned(pod):
            continue
        out.append(pod)
    out.sort(key=sort_key_by_creation)
    return out


def is_active(pod: Pod) -> bool:
    """Not terminally finished (Succeeded/Failed pods free their resources)."""
    return phase(pod) not in ("Succeeded", "Failed")


def used_units_by_chip(pods: Iterable[Pod]) -> dict[int, int]:
    """Annotation-declared HBM reservations of assigned labeled pods per
    chip index.

    Reference: ``getPodUsedGPUMemory`` (``podmanager.go:102-115``) counts
    only phase=Running pods; we deliberately count every *assigned*,
    non-terminal pod instead — a pod that Allocate() has placed holds its
    reservation while it is still Pending (image pull), and Running-only
    accounting would double-book the chip in that window.
    """
    used: dict[int, int] = {}
    for pod in pods:
        if not is_active(pod):
            continue
        if labels(pod).get(const.LABEL_RESOURCE_KEY) != const.LABEL_RESOURCE_VALUE:
            continue
        if not is_assigned(pod):
            continue
        gang = gang_usage_by_chip(pod)
        if gang:
            # multi-chip gang: the pod's total spreads per-chip over its
            # member chips (it deliberately carries no single IDX)
            for idx, per in gang.items():
                used[idx] = used.get(idx, 0) + per
            continue
        idx = chip_idx_from_annotation(pod)
        if idx < 0:
            continue
        used[idx] = used.get(idx, 0) + mem_units_of_pod(pod)
    return used


def core_hold_chips(pod: Pod) -> list[int]:
    """Chips one core pod holds. Primary source is the ``ENV_CORE_IDS``
    annotation the core allocator persists (kubelet may grant
    non-contiguous chips); legacy fallback is a contiguous range from the
    mem IDX annotation. One helper so the allocator ledger and the inspect
    CLI can never disagree about what a pod holds."""
    n = core_chips_of_pod(pod)
    if n <= 0:
        return []
    ids = core_ids_from_annotation(pod)
    if ids:
        return sorted(ids)
    idx = chip_idx_from_annotation(pod)
    if idx >= 0:
        return list(range(idx, idx + n))
    return []


def used_chips(pods: Iterable[Pod]) -> set[int]:
    """Chip indices exclusively held by assigned, non-terminal tpu-core
    pods (assigned-but-Pending holds count — see ``used_units_by_chip``)."""
    out: set[int] = set()
    for pod in pods:
        if not is_active(pod):
            continue
        if not is_assigned(pod):
            continue
        out.update(core_hold_chips(pod))
    return out
