"""Simulated-cluster churn driver for scale benches and chaos suites.

Counterpart of ``gpushare_device_plugin_tpu/extender/simcluster.py``,
copied whole: the same ``random.Random(seed)`` draws in the same order, so
one seed gives both packages the same cluster and the same churn.

The scale story needs a cluster three orders of magnitude past what the
dev box can host: this module synthesizes 1k-node catalogs with
heterogeneous chip topologies and drives Poisson pod churn (arrivals,
exponential lifetimes, periodic gang-group bursts) against any admission
function — the sharded router, a single extender core, or a future
scheduler — while recording per-admission latency and auditing the
resulting apiserver state for overcommit and partial gangs.

Virtual time: arrivals and deletions advance a simulated clock
(``rng.expovariate``), processed as fast as the host allows — the bench
measures the ADMISSION PATH's wall cost, not the trace's wall span.
Deterministic per seed.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
import threading
import time
from typing import Any, Callable, Sequence

from .. import const
from ..cluster import pods as P
from ..topology import shape_size
from ..utils.lockrank import make_lock
from . import logic

# Heterogeneous node classes: (topology label, chips). The mix mirrors a
# real fleet growing over hardware generations — small 4-chip hosts
# through 16-chip slabs — so slice enumeration and gang scoring see
# genuinely different grids, not 1k copies of one node.
NODE_CLASSES: tuple[tuple[str, int], ...] = (
    ("2x2x1", 4),
    ("2x2x2", 8),
    ("4x2x2", 16),
)

DEFAULT_CHIP_UNITS = 32  # HBM units per chip (the bench's GiB stand-in)


def synth_node(
    name: str, shape: str, chips: int, chip_units: int = DEFAULT_CHIP_UNITS
) -> dict:
    """One synthetic node JSON: per-chip capacity ``chip_units``, chip
    count ``chips``, and the topology label the slice enumerator reads."""
    total = chips * chip_units
    cap = {
        const.RESOURCE_MEM: str(total),
        const.RESOURCE_COUNT: str(chips),
    }
    return {
        "metadata": {
            "name": name,
            "labels": {const.LABEL_NODE_TOPOLOGY: shape},
            "resourceVersion": "1",
        },
        "status": {"capacity": dict(cap), "allocatable": dict(cap)},
    }


def make_cluster(
    n_nodes: int,
    seed: int = 0,
    chip_units: int = DEFAULT_CHIP_UNITS,
    prefix: str = "sim",
) -> list[dict]:
    """A deterministic heterogeneous catalog of ``n_nodes`` nodes."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        shape, chips = NODE_CLASSES[rng.randrange(len(NODE_CLASSES))]
        nodes.append(
            synth_node(f"{prefix}-{i:04d}", shape, chips, chip_units)
        )
    return nodes


@dataclasses.dataclass
class ChurnStats:
    """One churn run's outcome."""

    arrivals: int = 0
    admitted: int = 0
    rejected: int = 0
    retried: int = 0
    deleted: int = 0
    gang_groups: int = 0
    gang_members: int = 0
    gang_failed: int = 0
    degraded_consultations: int = 0
    admit_wall_s: float = 0.0  # summed per-admission time (utilization)
    wall_s: float = 0.0  # the whole run's wall span (throughput base)
    latencies_ms: list[float] = dataclasses.field(default_factory=list)

    def admissions_per_s(self) -> float:
        base = self.wall_s or self.admit_wall_s
        if base <= 0:
            return 0.0
        return self.admitted / base

    def latency_ms(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        ordered = sorted(self.latencies_ms)
        i = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[i]


class ChurnDriver:
    """Poisson churn against an admission function.

    ``admit_fn(pod) -> {"node": str, "error": str, ...}`` places one
    pod (the router's :meth:`ShardRouter.admit`, or an adapter over a
    single core); ``admit_gang_fn(pods) -> {"error": str, ...}`` places
    a gang group all-or-nothing (None disables gang bursts).
    ``create_pod_fn``/``delete_pod_fn`` mutate the (fake) apiserver the
    admission path reads — creation happens BEFORE admission, like a
    real scheduler seeing a Pending pod.

    Every ``gang_every``-th arrival becomes a burst: a gang group of
    ``gang_members`` pods, each requesting ``gang_shape``. Lifetimes are
    exponential with mean ``mean_lifetime`` in virtual seconds; a
    deleted gang group leaves whole.
    """

    def __init__(
        self,
        create_pod_fn: Callable[[dict], None],
        delete_pod_fn: Callable[[str, str], None],
        admit_fn: Callable[[dict], dict],
        admit_gang_fn: Callable[[Sequence[dict]], dict] | None = None,
        seed: int = 0,
        sizes: Sequence[int] = (2, 4, 6, 8, 12, 16),
        arrival_rate: float = 50.0,
        mean_lifetime: float = 30.0,
        gang_every: int = 0,
        gang_members: int = 2,
        gang_shape: str = "2x1",
        retry_once: bool = True,
        namespace: str = "default",
        workers: int = 1,
    ) -> None:
        self._create = create_pod_fn
        self._delete = delete_pod_fn
        self._admit = admit_fn
        self._admit_gang = admit_gang_fn
        self._rng = random.Random(seed)
        self._sizes = tuple(sizes)
        self._rate = arrival_rate
        self._lifetime = mean_lifetime
        self._gang_every = gang_every
        self._gang_members = gang_members
        self._gang_shape = gang_shape
        self._retry_once = retry_once
        self._ns = namespace
        self._workers = max(1, workers)
        self._seq = 0
        # virtual-clock deletion heap: (death time, tiebreak, [pod names])
        self._deaths: list[tuple[float, int, list[str]]] = []
        self._now = 0.0
        # stats/heap guard for the worker pool (pod NAMES and sizes stay
        # deterministic per seed — drawn by the single generator thread —
        # only the admission interleaving varies across runs)
        self._stats_lock = make_lock("extender.simchurn")

    def _make_pod(self, name: str, units: int, extra_ann: dict | None = None) -> dict:
        return {
            "metadata": {
                "name": name,
                "namespace": self._ns,
                "uid": f"sim-{name}",
                "creationTimestamp": "2026-01-01T00:00:00Z",
                "annotations": dict(extra_ann or {}),
                "labels": {},
            },
            "spec": {
                "nodeName": "",
                "containers": [{
                    "name": "c0",
                    "image": "sim",
                    "resources": {
                        "limits": {const.RESOURCE_MEM: str(units)}
                    },
                }],
            },
            "status": {"phase": "Pending"},
        }

    def _process_deaths(self, stats: ChurnStats) -> None:
        due: list[str] = []
        with self._stats_lock:
            while self._deaths and self._deaths[0][0] <= self._now:
                _t, _tb, names = heapq.heappop(self._deaths)
                due.extend(names)
        for name in due:
            self._delete(self._ns, name)
        with self._stats_lock:
            stats.deleted += len(due)

    def _schedule_death(self, names: list[str], delta: float) -> None:
        with self._stats_lock:
            self._seq += 1
            heapq.heappush(
                self._deaths, (self._now + delta, self._seq, names)
            )

    def _admit_one(self, pod: dict, stats: ChurnStats) -> bool:
        t0 = time.perf_counter()
        result = self._admit(pod)
        retried = False
        if result.get("error") and self._retry_once:
            retried = True
            result = self._admit(pod)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            if retried:
                stats.retried += 1
            stats.latencies_ms.append(dt * 1e3)
            stats.admit_wall_s += dt
            stats.degraded_consultations += len(
                result.get("degraded_shards") or ()
            )
        return not result.get("error")

    def run(self, events: int) -> ChurnStats:
        """Drive ``events`` arrival events (a gang burst counts as one
        event but creates ``gang_members`` pods); -> stats. With
        ``workers > 1`` admissions run on a thread pool (the storm's
        concurrency — HTTP round-trips to the apiserver overlap while
        the GIL serializes scoring, exactly the production shape)."""
        stats = ChurnStats()
        t_run = time.perf_counter()
        if self._workers <= 1:
            for item in self._generate(events, stats):
                self._execute(item, stats)
        else:
            import queue

            work: "queue.Queue" = queue.Queue(maxsize=self._workers * 4)

            def worker() -> None:
                while True:
                    item = work.get()
                    if item is None:
                        return
                    try:
                        self._execute(item, stats)
                    finally:
                        work.task_done()

            threads = [
                threading.Thread(target=worker, daemon=True)
                for _ in range(self._workers)
            ]
            for t in threads:
                t.start()
            for item in self._generate(events, stats):
                work.put(item)
            work.join()
            for _ in threads:
                work.put(None)
            for t in threads:
                t.join()
        # scheduled-but-not-due deletions stay: the run ends with a
        # populated cluster for the caller's audit pass
        stats.wall_s = time.perf_counter() - t_run
        return stats

    def _generate(self, events: int, stats: ChurnStats):
        """The single-threaded event source: draws every name, size, and
        death delta from ONE seeded generator (deterministic per seed),
        advances the virtual clock, and fires due deletions."""
        for i in range(events):
            self._now += self._rng.expovariate(self._rate)
            self._process_deaths(stats)
            with self._stats_lock:
                stats.arrivals += 1
                self._seq += 1
                seq = self._seq
            death = self._rng.expovariate(1.0 / self._lifetime)
            is_burst = (
                self._admit_gang is not None
                and self._gang_every > 0
                and (i + 1) % self._gang_every == 0
            )
            if is_burst:
                group = f"simgang-{seq}"
                per_chip = self._rng.choice(self._sizes[:3])
                size = shape_size(self._gang_shape)
                members = []
                for m in range(self._gang_members):
                    members.append(self._make_pod(
                        f"{group}-m{m}", per_chip * size,
                        extra_ann={
                            const.ANN_GANG_SHAPE: self._gang_shape,
                            const.ANN_GANG_GROUP: group,
                        },
                    ))
                yield ("gang", members, death)
            else:
                units = self._rng.choice(self._sizes)
                yield ("pod", self._make_pod(f"simpod-{seq}", units), death)

    def _execute(self, item: tuple, stats: ChurnStats) -> None:
        kind, payload, death = item
        if kind == "pod":
            pod = payload
            name = pod["metadata"]["name"]
            self._create(pod)
            if self._admit_one(pod, stats):
                with self._stats_lock:
                    stats.admitted += 1
                self._schedule_death([name], death)
            else:
                with self._stats_lock:
                    stats.rejected += 1
                self._delete(self._ns, name)
            return
        members = payload
        with self._stats_lock:
            stats.gang_groups += 1
            stats.gang_members += len(members)
        for pod in members:
            self._create(pod)
        t0 = time.perf_counter()
        result = self._admit_gang(members)
        dt = time.perf_counter() - t0
        with self._stats_lock:
            stats.admit_wall_s += dt
        if result.get("error"):
            with self._stats_lock:
                stats.gang_failed += 1
            for pod in members:
                self._delete(self._ns, pod["metadata"]["name"])
        else:
            with self._stats_lock:
                stats.admitted += len(members)
            self._schedule_death(
                [p["metadata"]["name"] for p in members], death,
            )


def audit_cluster(nodes: list[dict], pods: list[dict]) -> list[str]:
    """Invariant audit over (fake) apiserver state; -> violations.

    - no chip on any node holds more annotated units than its capacity
      (the cross-shard double-booking check), and no annotation names a
      chip the node does not have;
    - every granted share pod is bound to a KNOWN node — a pod carrying
      chip annotations but no (or an unknown) nodeName is counted
      nowhere, the under-count that masks a double-booking;
    - every gang GROUP is whole: all members carry their gang grant or
      none do (no partial gang visible).
    """
    violations: list[str] = []
    active = [p for p in pods if P.is_active(p)]
    known = {n.get("metadata", {}).get("name", "") for n in nodes}
    for pod in active:
        ann = P.annotations(pod)
        granted = (
            const.ENV_MEM_IDX in ann or const.ENV_GANG_CHIPS in ann
        )
        if granted and P.node_name(pod) not in known:
            violations.append(
                f"{pod.get('metadata', {}).get('name', '?')}: granted "
                f"chips but bound to unknown node "
                f"{P.node_name(pod)!r} — counted nowhere"
            )
    by_node = logic.group_pods_by_node(active)
    for node in nodes:
        name = node.get("metadata", {}).get("name", "")
        capacity = logic.node_capacity(node, const.RESOURCE_MEM)
        if not capacity:
            continue
        used = logic.node_usage(by_node.get(name, []), const.RESOURCE_MEM)
        for chip, units in used.items():
            cap = capacity.get(chip)
            if cap is None:
                violations.append(
                    f"{name}: annotated chip {chip} does not exist"
                )
            elif units > cap:
                violations.append(
                    f"{name}: chip {chip} overcommitted ({units} > {cap})"
                )
    groups: dict[str, list[dict]] = {}
    for pod in pods:
        gid = P.gang_group(pod)
        if gid:
            groups.setdefault(gid, []).append(pod)
    for gid, members in groups.items():
        granted = [
            bool(P.gang_chips_from_annotation(p)) for p in members
        ]
        if any(granted) and not all(granted):
            violations.append(
                f"gang group {gid}: partial grant "
                f"({sum(granted)}/{len(granted)} members bound)"
            )
    return violations


def audit_no_cross_shard_double_booking(
    nodes: list[dict], pods: list[dict]
) -> list[str]:
    """Alias with the acceptance criterion's name: overcommit on any
    chip IS a double-booking — two admissions (from any shards) were
    granted overlapping capacity."""
    return [v for v in audit_cluster(nodes, pods) if "overcommit" in v
            or "does not exist" in v]


def pending_share_pods(pods: list[dict]) -> list[dict]:
    """Share pods still awaiting placement (diagnostics for drivers)."""
    out = []
    for pod in pods:
        if not P.is_active(pod):
            continue
        if P.mem_units_of_pod(pod) <= 0:
            continue
        ann = P.annotations(pod)
        if const.ENV_MEM_IDX in ann or const.ENV_GANG_CHIPS in ann:
            continue
        out.append(pod)
    return out


def summarize(stats: ChurnStats) -> dict[str, Any]:
    """JSON-ready stats block for bench reports."""
    return {
        "arrivals": stats.arrivals,
        "admitted": stats.admitted,
        "rejected": stats.rejected,
        "retried": stats.retried,
        "deleted": stats.deleted,
        "gang_groups": stats.gang_groups,
        "gang_failed": stats.gang_failed,
        "degraded_consultations": stats.degraded_consultations,
        "admissions_per_s": round(stats.admissions_per_s(), 1),
        "admit_p50_ms": round(stats.latency_ms(0.50), 3),
        "admit_p99_ms": round(stats.latency_ms(0.99), 3),
    }
