"""Scheduler-extender placement logic (pure functions).

Counterpart of ``gpushare_device_plugin_tpu/extender/logic.py``, copied
whole: the same filter, score vectors, gang evaluation and chip choice, so
one cluster state gives both packages the same decision and the same
annotations byte for byte.

The upstream device plugin relies on a separate gpushare-scheduler-extender
for cluster-level binpack placement; the node agent reads its ``..._IDX``
annotation when it admits the pod. This module is the in-repo equivalent:
node filtering, binpack scoring, and the bind-time chip decision,
generalized over resource names so one extender serves ``aliyun.com/tpu-mem``
and ``aliyun.com/gpu-mem`` nodes in a mixed fleet (the port's node agent
advertises an H100's memory under the former).

A pod counts against a node's chips when it is active (phase not
Succeeded/Failed) and carries the IDX annotation — i.e. running workloads
AND extender-assumed pods whose kubelet admission is still in flight.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

from .. import const
from ..allocator.binpack import AssignmentError, assign_chip
from ..cluster import pods as P
from ..cluster.noderes import chip_capacity_vector
from ..topology import ChipTopology, shape_size
from ..utils.decisions import ScoreVector
from .policy import PlacementPolicy, PolicyView
from . import policy as policy_mod

# Every scoring entry point accepts either a legacy chip-policy name
# ("best-fit"/"first-fit"/"spread" — resolved through the policy
# registry to the bit-identical binpack scorer) or an already-
# constructed PlacementPolicy ("greedy-binpack"/"multi-objective"/
# "learned"/anything registered). Resolution happens once per verb.

# resource name -> annotation/label vocabulary
RESOURCE_FAMILIES = {
    const.RESOURCE_MEM: {
        "count": const.RESOURCE_COUNT,
        "idx": const.ENV_MEM_IDX,
        "pod": const.ENV_MEM_POD,
        "dev": const.ENV_MEM_DEV,
        "assigned": const.ENV_ASSIGNED_FLAG,
        "assume": const.ENV_ASSUME_TIME,
    },
    const.RESOURCE_GPU_MEM: {
        "count": const.RESOURCE_GPU_COUNT,
        "idx": const.ENV_GPU_MEM_IDX,
        "pod": const.ENV_GPU_MEM_POD,
        "dev": const.ENV_GPU_MEM_DEV,
        "assigned": const.ENV_GPU_MEM_ASSIGNED,
        "assume": const.ENV_GPU_MEM_ASSUME_TIME,
    },
}


def pod_resource(pod: dict) -> str | None:
    """Which share resource this pod requests (tpu-mem preferred)."""
    for resource in RESOURCE_FAMILIES:
        if P.mem_units_of_pod(pod, resource=resource) > 0:
            return resource
    return None


@dataclasses.dataclass
class NodeView:
    name: str
    resource: str
    capacity: dict[int, int]  # chip index -> units
    used: dict[int, int]
    # chips exclusively held by assigned tpu-core pods: zero free units for
    # fractional placement (keeps the extender's decisions consistent with
    # the device plugin's cross-resource ledger — otherwise it would assume
    # mem pods onto held chips and Allocate would reject them forever)
    core_held: set[int] = dataclasses.field(default_factory=set)
    # the node's chip grid, for gang (multi-chip) placement; None on
    # resource families without an interconnect (gpu-mem)
    topology: ChipTopology | None = None

    def free(self) -> dict[int, int]:
        return {
            i: (
                0
                if i in self.core_held
                else self.capacity[i] - self.used.get(i, 0)
            )
            for i in self.capacity
        }


def node_topology(node: dict, capacity: dict[int, int]) -> ChipTopology | None:
    """The node's chip grid (``ChipTopology.from_node`` — the one label
    rule shared with the daemon and the inspect CLI); None when the node
    advertises no chips."""
    if not capacity:
        return None
    return ChipTopology.from_node(node, len(capacity))


def node_capacity(node: dict, resource: str) -> dict[int, int]:
    """Per-chip capacity from node status (shared helper with the inspect CLI)."""
    return chip_capacity_vector(node, resource, RESOURCE_FAMILIES[resource]["count"])


def group_pods_by_node(pods: list[dict]) -> dict[str, list[dict]]:
    """Group once per request so per-node accounting doesn't rescan the
    whole cluster pod list for every node."""
    by_node: dict[str, list[dict]] = {}
    for pod in pods:
        by_node.setdefault(P.node_name(pod), []).append(pod)
    return by_node


def node_usage(node_pods: list[dict], resource: str) -> dict[int, int]:
    """Units held per chip by active annotated pods (pods pre-filtered to
    one node via ``group_pods_by_node``)."""
    family = RESOURCE_FAMILIES[resource]
    used: dict[int, int] = {}
    for pod in node_pods:
        if P.phase(pod) in ("Succeeded", "Failed"):
            continue
        if resource == const.RESOURCE_MEM:
            gang = P.gang_usage_by_chip(pod)
            if gang:
                for idx, per in gang.items():
                    used[idx] = used.get(idx, 0) + per
                continue
        idx_raw = P.annotations(pod).get(family["idx"])
        if idx_raw is None:
            continue
        try:
            idx = int(idx_raw)
        except ValueError:
            continue
        if idx < 0:
            continue
        used[idx] = used.get(idx, 0) + P.mem_units_of_pod(pod, resource=resource)
    return used


def build_node_view(
    node: dict, pods_by_node: dict[str, list[dict]], resource: str
) -> NodeView:
    name = node.get("metadata", {}).get("name", "")
    node_pods = pods_by_node.get(name, [])
    capacity = node_capacity(node, resource)
    return NodeView(
        name=name,
        resource=resource,
        capacity=capacity,
        used=node_usage(node_pods, resource),
        core_held=(
            P.used_chips(node_pods) if resource == const.RESOURCE_MEM else set()
        ),
        topology=(
            node_topology(node, capacity)
            if resource == const.RESOURCE_MEM
            else None
        ),
    )


def node_fits(view: NodeView, request_units: int) -> bool:
    """A single chip must hold the whole request (no cross-chip spreading
    for fractional pods — same constraint the device plugin enforces)."""
    return any(f >= request_units for f in view.free().values())


def pod_gang_shape(pod: dict, resource: str) -> str:
    """The pod's gang-shape request, "" for single-chip pods. Gangs ride
    the TPU family only — GPU nodes have no ICI grid to place against."""
    if resource != const.RESOURCE_MEM:
        return ""
    return P.gang_shape_request(pod)


def _zero_score(pol: PlacementPolicy, request_units: int) -> ScoreVector:
    return ScoreVector(
        policy=pol.name, raw=0.0, free_units=0,
        request_units=request_units, binpack=0.0,
    )


def _gang_eval(
    view: NodeView,
    shape_raw: str,
    request_units: int,
    policy: "str | PlacementPolicy",
) -> tuple["object | None", int, str, ScoreVector]:
    """One node's gang answer: -> (best candidate or None, per-chip
    units, failure reason, :class:`ScoreVector`). The score reuses the
    single-chip policy semantics at per-chip granularity over the
    winning slice's members — so gang and single-chip node ranking stay
    comparable — and carries the slice's multi-objective components
    (ICI hops, stranded slivers, broken chips, tie-break) from
    ``best_slice_scored`` for decision provenance. A non-legacy
    :class:`PlacementPolicy` sees those components in its
    :class:`PolicyView` and may let them move the raw score (the
    multi-objective / learned policies do)."""
    pol = policy_mod.resolve(policy)
    try:
        size = shape_size(shape_raw)
    except ValueError as e:
        return (
            None, 0, f"invalid gang shape {shape_raw!r}: {e}",
            _zero_score(pol, request_units),
        )
    if size < 1 or request_units <= 0 or request_units % size:
        return (
            None, 0,
            f"{request_units} units of {view.resource} do not divide "
            f"evenly over gang shape {shape_raw!r} ({size} chips)",
            _zero_score(pol, request_units),
        )
    per_chip = request_units // size
    topo = view.topology or node_topology({}, view.capacity)
    if topo is None:
        return (
            None, 0, f"node does not advertise {view.resource}",
            _zero_score(pol, request_units),
        )
    free = view.free()
    scored = topo.best_slice_scored(
        shape_raw, free, per_chip,
        capacity=view.capacity, excluded=view.core_held,
    )
    if scored is None:
        return (
            None, per_chip,
            f"no {shape_raw} sub-slice with {per_chip} free units of "
            f"{view.resource} per chip (free: {free})",
            _zero_score(pol, per_chip),
        )
    cand, slice_score = scored
    member_free = [free[i] for i in cand.chips]
    feasible = [f for f in member_free if f >= per_chip]
    cap = max(view.capacity.values(), default=0)
    if not feasible or cap <= 0:
        score = _zero_score(pol, per_chip)
    else:
        decisive = (
            max(feasible) if pol.chip_policy == "spread" else min(feasible)
        )
        score = pol.score(PolicyView(
            free_units=decisive, capacity=cap, request_units=per_chip,
            free_vector=tuple(feasible),
            ici_hops=slice_score.hops, stranded=slice_score.stranded,
            broken=slice_score.broken, tie_break=slice_score.tie_break,
        ))
    return cand, per_chip, "", score


def gang_candidate(
    view: NodeView,
    shape_raw: str,
    request_units: int,
    policy: "str | PlacementPolicy" = "best-fit",
) -> tuple["object | None", int, str, ScoreVector]:
    """Public form of the per-node gang evaluation (``_gang_eval``) for
    planners — the shard router's cross-node gang-group placement picks
    each member's (slice, per-chip units) through this: -> (candidate
    slice or None, per-chip units, failure reason, score)."""
    return _gang_eval(view, shape_raw, request_units, policy)


def evaluate_filter(
    request_units: int, views: list[NodeView], gang_shape: str = ""
) -> tuple[list[str], dict[str, str]]:
    """Fit check over prebuilt views -> (fitting names, name -> reason)."""
    fits, failed = [], {}
    pol = policy_mod.resolve("best-fit")
    for view in views:
        if not view.capacity:
            failed[view.name] = f"node does not advertise {view.resource}"
        elif gang_shape:
            cand, _per, reason, _s = _gang_eval(
                view, gang_shape, request_units, pol
            )
            if cand is None:
                failed[view.name] = reason
            else:
                fits.append(view.name)
        elif not node_fits(view, request_units):
            failed[view.name] = (
                f"no single chip with {request_units} free units of "
                f"{view.resource} (free: {view.free()})"
            )
        else:
            fits.append(view.name)
    return fits, failed


def views_from_pods(
    pods: list[dict],
) -> Callable[[str, list[dict]], list["NodeView"]]:
    """views_fn over a full pod list (the LIST-backed path); the extender
    server passes its index-backed equivalent instead."""

    def views(resource: str, nodes: list[dict]) -> list[NodeView]:
        by_node = group_pods_by_node(pods)
        return [build_node_view(n, by_node, resource) for n in nodes]

    return views


def filter_with_views(
    pod: dict,
    nodes: list[dict],
    views_fn: Callable[[str, list[dict]], list["NodeView"]],
) -> tuple[list[str], dict[str, str]]:
    """-> (fitting node names, failed node -> reason).

    ``views_fn(resource, nodes) -> list[NodeView]`` supplies the accounting
    (full-scan or incremental-index) — verb semantics live here once."""
    resource = pod_resource(pod)
    if resource is None:
        # not a share pod: everything passes (we shouldn't be called, but
        # the scheduler may still route the pod through the extender)
        return [n.get("metadata", {}).get("name", "") for n in nodes], {}
    request = P.mem_units_of_pod(pod, resource=resource)
    return evaluate_filter(
        request, views_fn(resource, nodes),
        gang_shape=pod_gang_shape(pod, resource),
    )


def filter_nodes(
    pod: dict, nodes: list[dict], pods: list[dict]
) -> tuple[list[str], dict[str, str]]:
    return filter_with_views(pod, nodes, views_from_pods(pods))


def _score_free(
    free_values, cap: int, request_units: int,
    policy: "str | PlacementPolicy",
) -> ScoreVector:
    """The policy score over a free vector as a structured
    :class:`ScoreVector`: the raw fractional 0-10 score (full
    resolution — the deterministic tie-break the integer projection
    cannot provide at fleet scale), the decisive chip's free units, and
    the binpack slack term. Chip selection (tightest feasible for
    packing, roomiest for spread — ``PlacementPolicy.chip_policy``)
    lives here; the scoring formula is the policy's ``score`` over a
    :class:`PolicyView` (legacy names resolve to the ``chip_breakdown``
    scorer — ONE implementation shared with the allocator's provenance
    records, bit-identical to the pre-registry behavior, pinned by the
    existing verb tests)."""
    pol = policy_mod.resolve(policy)
    feasible = [f for f in free_values if f >= request_units]
    if not feasible or cap <= 0:
        return _zero_score(pol, request_units)
    decisive = max(feasible) if pol.chip_policy == "spread" else min(feasible)
    return pol.score(PolicyView(
        free_units=decisive, capacity=cap, request_units=request_units,
        free_vector=tuple(feasible),
    ))


def score_node_vector(
    view: NodeView, request_units: int,
    policy: "str | PlacementPolicy" = "best-fit",
) -> ScoreVector:
    """Node score as a structured :class:`ScoreVector`, consistent with
    the chip-level policy.

    Packing policies (first-fit/best-fit) prefer the node whose tightest
    feasible chip leaves the least slack (consolidates fragments, keeps
    big chips whole); ``spread`` inverts — prefer the node whose emptiest
    feasible chip has the MOST headroom, so pods fan out across nodes the
    same way they fan out across chips."""
    return _score_free(
        view.free().values(),
        max(view.capacity.values(), default=0),
        request_units,
        policy,
    )


def score_node(
    view: NodeView, request_units: int,
    policy: "str | PlacementPolicy" = "best-fit",
) -> int:
    """Node score 0-10 (the webhook wire projection of
    :func:`score_node_vector`)."""
    return score_node_vector(view, request_units, policy).projected


def chip_score_vector(
    view: NodeView, idx: int, request_units: int,
    policy: "str | PlacementPolicy" = "best-fit",
) -> ScoreVector:
    """The breakdown for one CHOSEN chip (bind-time provenance): the
    chip's pre-claim free units and its slack term, with the chip index
    as the tie-break. Unlike :func:`score_node_vector` this scores the
    concrete decision, not the node's best case."""
    pol = policy_mod.resolve(policy)
    free = view.free()
    return pol.score(PolicyView(
        free_units=free.get(idx, 0),
        capacity=max(view.capacity.values(), default=0),
        request_units=request_units,
        free_vector=tuple(f for f in free.values() if f >= request_units),
        chip=idx,
    ))


def evaluate_filter_and_scores(
    request_units: int,
    views: list[NodeView],
    policy: "str | PlacementPolicy" = "best-fit",
    gang_shape: str = "",
) -> tuple[list[str], dict[str, str], dict[str, ScoreVector]]:
    """One pass over prebuilt views -> (fits, failed reasons, score
    breakdowns for the fitting nodes). The batched filter+prioritize:
    each view's free vector is computed once and serves both the fit
    check and the score, where the two-verb protocol recomputes it per
    verb. Scores are full :class:`ScoreVector` breakdowns — the webhook
    response projects ``.projected``; the decision record keeps the
    whole vector."""
    fits: list[str] = []
    failed: dict[str, str] = {}
    scores: dict[str, ScoreVector] = {}
    pol = policy_mod.resolve(policy)
    for view in views:
        if not view.capacity:
            failed[view.name] = f"node does not advertise {view.resource}"
            continue
        if gang_shape:
            cand, _per, reason, score = _gang_eval(
                view, gang_shape, request_units, pol
            )
            if cand is None:
                failed[view.name] = reason
            else:
                fits.append(view.name)
                scores[view.name] = score
            continue
        free = view.free()
        if not any(f >= request_units for f in free.values()):
            failed[view.name] = (
                f"no single chip with {request_units} free units of "
                f"{view.resource} (free: {free})"
            )
            continue
        fits.append(view.name)
        scores[view.name] = _score_free(
            free.values(),
            max(view.capacity.values(), default=0),
            request_units,
            pol,
        )
    return fits, failed, scores


def evaluate_score_vectors(
    request_units: int,
    views: list[NodeView],
    policy: "str | PlacementPolicy" = "best-fit",
    gang_shape: str = "",
) -> dict[str, ScoreVector]:
    pol = policy_mod.resolve(policy)
    if gang_shape:
        return {
            v.name: _gang_eval(v, gang_shape, request_units, pol)[3]
            for v in views
        }
    return {
        v.name: score_node_vector(v, request_units, pol) for v in views
    }


def evaluate_scores(
    request_units: int,
    views: list[NodeView],
    policy: "str | PlacementPolicy" = "best-fit",
    gang_shape: str = "",
) -> dict[str, int]:
    """The 0-10 wire projection of :func:`evaluate_score_vectors`."""
    return {
        name: sv.projected
        for name, sv in evaluate_score_vectors(
            request_units, views, policy, gang_shape
        ).items()
    }


def prioritize_with_views(
    pod: dict,
    nodes: list[dict],
    views_fn: Callable[[str, list[dict]], list["NodeView"]],
    policy: "str | PlacementPolicy" = "best-fit",
) -> dict[str, ScoreVector]:
    """Per-node score breakdowns for the prioritize verb. The webhook
    projects each vector to its pinned 0-10 integer; the decision
    record keeps the full-resolution breakdown."""
    resource = pod_resource(pod)
    if resource is None:
        return {
            n.get("metadata", {}).get("name", ""): _zero_score(policy, 0)
            for n in nodes
        }
    request = P.mem_units_of_pod(pod, resource=resource)
    return evaluate_score_vectors(
        request, views_fn(resource, nodes), policy,
        gang_shape=pod_gang_shape(pod, resource),
    )


def prioritize_nodes(
    pod: dict, nodes: list[dict], pods: list[dict], policy: "str | PlacementPolicy" = "best-fit"
) -> dict[str, int]:
    return {
        name: sv.projected
        for name, sv in prioritize_with_views(
            pod, nodes, views_from_pods(pods), policy
        ).items()
    }


def choose_chip(
    pod: dict, node: dict, pods: list[dict], policy: "str | PlacementPolicy" = "best-fit"
) -> tuple[str, int, dict[str, str]]:
    """Bind-time decision: -> (resource, chip index, annotations to write).

    Raises ``AssignmentError`` when nothing fits anymore (the scheduler
    will retry the pod).
    """
    resource = pod_resource(pod)
    if resource is None:
        raise AssignmentError("pod requests no share resource")
    view = build_node_view(node, group_pods_by_node(pods), resource)
    return choose_chip_from_view(pod, view, policy=policy)


def choose_gang_from_view(
    pod: dict, view: NodeView, policy: "str | PlacementPolicy" = "best-fit"
) -> tuple[str, tuple[int, ...], int, dict[str, str]]:
    """Bind-time gang decision over a prebuilt view: -> (resource, member
    chips, per-chip units, annotations to write). The score-less form of
    :func:`choose_gang_scored`."""
    resource, chips, per_chip, annotations, _score = choose_gang_scored(
        pod, view, policy=policy
    )
    return resource, chips, per_chip, annotations


def choose_gang_scored(
    pod: dict, view: NodeView, policy: "str | PlacementPolicy" = "best-fit"
) -> tuple[str, tuple[int, ...], int, dict[str, str], ScoreVector]:
    """Bind-time gang decision over a prebuilt view: -> (resource, member
    chips, per-chip units, annotations to write, score breakdown). The
    annotations are the whole gang in ONE write — member chips,
    normalized shape, per-chip share, assigned=false — so the claim
    lands all-or-nothing and the device plugin's branch A can
    re-validate and honor it atomically. The :class:`ScoreVector` is the
    winning slice's breakdown, surfaced for the bind decision record.
    Raises ``AssignmentError`` when no feasible sub-slice remains."""
    resource = view.resource
    family = RESOURCE_FAMILIES[resource]
    shape_raw = pod_gang_shape(pod, resource)
    request = P.mem_units_of_pod(pod, resource=resource)
    cand, per_chip, reason, score = _gang_eval(
        view, shape_raw, request, policy
    )
    if cand is None:
        raise AssignmentError(reason)
    containers = pod.get("spec", {}).get("containers", [])
    alloc_map = {}
    for i, c in enumerate(containers):
        units = P.mem_units_of_container(c, resource)
        if units <= 0:
            continue
        per = units // len(cand.chips)
        alloc_map[c.get("name", f"c{i}")] = {
            str(idx): per for idx in cand.chips
        }
    annotations = {
        const.ENV_GANG_CHIPS: ",".join(str(i) for i in cand.chips),
        const.ENV_GANG_SHAPE: "x".join(str(d) for d in cand.shape),
        const.ENV_GANG_PER_CHIP: str(per_chip),
        family["pod"]: str(request),
        family["dev"]: str(view.capacity.get(cand.chips[0], 0)),
        family["assigned"]: "false",  # plugin flips to true at admission
        family["assume"]: str(time.time_ns()),
        const.ANN_EXTENDER_ALLOCATION: json.dumps(alloc_map),
    }
    return resource, cand.chips, per_chip, annotations, score


def choose_chip_from_view(
    pod: dict, view: NodeView, policy: "str | PlacementPolicy" = "best-fit"
) -> tuple[str, int, dict[str, str]]:
    """``choose_chip`` over a prebuilt view (the index-backed path); the
    score-less form of :func:`choose_chip_scored`."""
    resource, idx, annotations, _score = choose_chip_scored(
        pod, view, policy=policy
    )
    return resource, idx, annotations


def choose_chip_scored(
    pod: dict, view: NodeView, policy: "str | PlacementPolicy" = "best-fit"
) -> tuple[str, int, dict[str, str], ScoreVector]:
    """``choose_chip`` over a prebuilt view, plus the chosen chip's
    score breakdown (pre-claim free units, binpack slack) for the bind
    decision record."""
    resource = view.resource
    family = RESOURCE_FAMILIES[resource]
    pol = policy_mod.resolve(policy)
    request = P.mem_units_of_pod(pod, resource=resource)
    idx = assign_chip(
        request,
        view.capacity,
        view.used,
        unhealthy=sorted(view.core_held),
        policy=pol.chip_policy,
    )
    score = chip_score_vector(view, idx, request, pol)
    containers = pod.get("spec", {}).get("containers", [])
    alloc_map = {
        c.get("name", f"c{i}"): {str(idx): P.mem_units_of_container(c, resource)}
        for i, c in enumerate(containers)
        if P.mem_units_of_container(c, resource) > 0
    }
    annotations = {
        family["idx"]: str(idx),
        family["pod"]: str(request),
        family["dev"]: str(view.capacity.get(idx, 0)),
        family["assigned"]: "false",  # plugin flips to true at admission
        family["assume"]: str(time.time_ns()),
        const.ANN_EXTENDER_ALLOCATION: json.dumps(alloc_map),
    }
    return resource, idx, annotations, score
