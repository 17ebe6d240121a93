"""Horizontally sharded scheduler extender.

Counterpart of ``gpushare_device_plugin_tpu/extender/shards.py``, copied
whole. The ring hashes with blake2b to an 8-byte digest as the
reference's does, so every router and shard of either package derives the
same ownership, and the ``gang2pc`` journal records are the reference's:
a WAL written by one package's shard resolves in the other's
:func:`resolve_gang2pc`. Run it as ``python -m
gpushare_device_plugin_tpu_torch.extender.shards``. Three differences:
``main`` exits 0 on SIGTERM, as the port's single extender does
(``server.py``); it arms ``TPUSHARE_FAULTS`` as the node agent's daemon
does (the reference's ignores the variable), so a live router can be
killed at a ``gang2pc`` step; and each shard's usage views read the
in-flight overlay before the usage index (``server.py``), which closes a
double-booking the reference's concurrent churn can hit.

One extender process funnels every admission's O(cluster-nodes) scoring
pass and its bind WAL fsync through one core. This module shards the
extender by NODE ownership:

- :class:`HashRing` — consistent-hash partitioning of nodes across N
  shards (virtual nodes for balance, minimal remap on resize). Each
  node has exactly ONE owner shard, so single-node placements have a
  single writer and cannot race across shards by construction.
- :class:`ShardExtender` — one shard: a full :class:`ExtenderCore`
  scoring from snapshot reads of its OWN informer index, journaling
  binds into its OWN per-shard group-commit WAL, plus the cross-shard
  two-phase-commit participant half (prepare/commit/abort of "gang2pc"
  reservations through an :class:`AssumeCache` ledger).
- :class:`ShardRouter` — a thin stateless router that fans webhook
  verbs out to the owning shards and merges ranked
  :class:`ScoreVector` results (projecting to the 0-10 wire scale only
  at its own edge). Shards that fail a fan-out land in
  ``degraded_shards`` on the merged decision record — "not consulted"
  is distinguishable from "rejected". The admission hot path
  (:meth:`ShardRouter.admit`) consults only the ``fanout`` most
  promising shards by cached free-capacity summaries — the
  work-reduction that buys the scale win (kube-scheduler's
  percentage-of-nodes-to-score, sharded) — and falls back to a full
  fan-out before declaring a pod unschedulable.
- Cross-shard gang groups — pods sharing ``ANN_GANG_GROUP`` are one
  distributed job whose members land on different nodes (and therefore
  different shards) and must be admitted all-or-nothing. The router
  runs a leader-elected two-phase reserve: the coordinator shard (the
  ring owner of the group id, fenced by a :class:`LeaderLease` epoch)
  collects a placement plan, every member shard journals a "gang2pc"
  prepare record and books the chips in its ledger BEFORE any member
  binds, the coordinator journals ONE durable commit/abort decision,
  and only then do members bind. :func:`resolve_gang2pc` is the
  reconciler half: incomplete prepares roll back, durable commit
  decisions roll forward — by phase, like the defragmenter's move
  protocol — so a crash at ANY step leaves zero partial gangs and zero
  orphaned cross-shard reservations.

Ledger discipline: this module touches :class:`AssumeCache` ONLY through
the 2PC reserve API (claim/renew/reserve_gang/release/is_claimed/
gang_snapshot/expire_stale) — never per-shard internals, and never the
single-chip reservation families (a gang must not double-book against
them).
"""

from __future__ import annotations

import bisect
import hashlib
import json
import time
from typing import Any, Iterable, Sequence

from .. import const
from ..allocator.assume import AssumeCache, PodKey
from ..cluster import pods as P
from ..cluster.apiserver import ApiError, ApiServerClient
from ..utils.decisions import DECISIONS, ScoreVector, rank_scores
from ..utils.faults import FAULTS
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY
from . import logic
from .server import ExtenderCore
from ..utils.metric_catalog import GANG2PC_TOTAL as TWOPC_METRIC

# A committed 2PC reservation normally drains when the watch shows the
# annotated pod on its node. Two paths never get that signal: the pod
# deleted before any scoring read observed it, and list-source cores
# with no informer at all. After this grace the reservation releases
# anyway — by then either the pod source counts the real pod (release
# is correct) or the pod is gone (release is overdue); holding longer
# only strands capacity.
COMMIT_VISIBILITY_GRACE_S = 60.0

# How long an undecided prepare belonging to a LIVE coordinator (its
# lease epoch still held) is protected from the reconciler's presumed-
# abort rollback. A live protocol finishes in milliseconds; a prepare
# this old under a still-held lease means the coordinator wedged, and
# the override then both rolls back AND FENCES: the resolver takes a
# higher lease epoch and seeds it onto the member + coordinator shards,
# so a late-waking driver hits StaleCoordinator at its (epoch-gated)
# decision point instead of committing on top of re-booked chips.
# Without the gate itself, the live resolve loop could roll back a
# prepare the coordinator was about to decide on — releasing chips its
# durable decision later rolls FORWARD onto, after a competing group
# booked them: the gang double-booking one layer up, found by
# tools/tpumc (model "gang2pc-resolve", pinned in tests/test_tpumc.py).
LIVE_PREPARE_GRACE_S = 60.0

log = get_logger("shards")

# Synthetic namespace for cross-shard two-phase reservations in the
# ledger (the defrag mover's "tpushare-defrag" pattern): keys under it
# can never collide with a real pod's admission claim.
GANG2PC_NS = "tpushare-gang2pc"

WAL_KIND_2PC = "gang2pc"

TWOPC_HELP = (
    "Cross-shard two-phase gang operations by phase and outcome "
    "(prepare/decide/commit/abort/rollforward/rollback)"
)


class ShardUnavailable(ConnectionError):
    """A shard could not be consulted (partitioned, crashed): the router
    records it in ``degraded_shards`` instead of failing the verb."""


class StaleCoordinator(RuntimeError):
    """A 2PC message carried a fenced coordinator epoch: a newer leader
    has taken over this group and the old one must stop driving it."""


# --- consistent-hash ring ---------------------------------------------------


def _h64(data: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ownership of node names across shard ids.

    ``vnodes`` virtual points per shard keep the partition balanced
    (128 points put the max/mean node spread around ~15% at 1k nodes);
    resizing from N to N+1 shards remaps ~1/(N+1) of the nodes instead
    of reshuffling the world. Pure function of (shard_ids, vnodes) —
    every router and every shard derive the SAME ownership with no
    coordination."""

    def __init__(self, shard_ids: Sequence[str], vnodes: int = 128) -> None:
        if not shard_ids:
            raise ValueError("hash ring needs at least one shard")
        self._shard_ids = tuple(shard_ids)
        self._vnodes = vnodes
        points: list[tuple[int, str]] = []
        for sid in self._shard_ids:
            for v in range(vnodes):
                points.append((_h64(f"{sid}#{v}"), sid))
        points.sort()
        self._points = points
        self._keys = [p[0] for p in points]

    @property
    def shard_ids(self) -> tuple[str, ...]:
        return self._shard_ids

    def owner(self, name: str) -> str:
        """The shard owning ``name`` (a node name, or any key needing a
        deterministic home — gang-group leader election hashes the
        group id through the same ring)."""
        h = _h64(name)
        i = bisect.bisect_right(self._keys, h)
        if i >= len(self._points):
            i = 0
        return self._points[i][1]

    def partition(self, names: Iterable[str]) -> dict[str, list[str]]:
        """Group ``names`` by owner shard (owners with no names absent)."""
        out: dict[str, list[str]] = {}
        for name in names:
            out.setdefault(self.owner(name), []).append(name)
        return out

    def doc(self, node_names: Iterable[str] = ()) -> dict[str, Any]:
        """Ring summary for the shard-map CLI."""
        counts = {sid: 0 for sid in self._shard_ids}
        for name in node_names:
            counts[self.owner(name)] += 1
        return {
            "shards": len(self._shard_ids),
            "vnodes": self._vnodes,
            "nodes_per_shard": counts,
        }


# --- leader lease -----------------------------------------------------------


class LeaderLease:
    """Per-gang-group coordinator epochs — the 2PC fencing tokens.

    ``acquire`` hands the caller a strictly higher epoch for the group
    and records it as current; participants reject 2PC messages whose
    epoch is below the highest they have seen, so a coordinator that
    lost its lease mid-protocol (chaos: "leader fenced mid-commit")
    cannot keep driving — the new leader re-drives from the journaled
    state via :func:`resolve_gang2pc`."""

    def __init__(self) -> None:
        self._lock = make_lock("extender.lease")
        self._epochs: dict[str, int] = {}
        self._holders: dict[str, str] = {}

    def acquire(self, group: str, shard_id: str) -> int:
        with self._lock:
            epoch = self._epochs.get(group, 0) + 1
            self._epochs[group] = epoch
            self._holders[group] = shard_id
            return epoch

    def current(self, group: str) -> tuple[str, int]:
        """(holder shard id, epoch); ("", 0) when never acquired."""
        with self._lock:
            return self._holders.get(group, ""), self._epochs.get(group, 0)

    def forget(self, group: str) -> None:
        """Drop a finished group's lease state (bounded tables)."""
        with self._lock:
            self._epochs.pop(group, None)
            self._holders.pop(group, None)


# --- one shard --------------------------------------------------------------


class ShardExtender:
    """One horizontal shard of the extender.

    Owns a full :class:`ExtenderCore` (its own informer usage index,
    NodeView cache, in-flight overlay, and per-shard group-commit bind
    WAL) restricted by the router to the ring's nodes, plus the 2PC
    participant half: journaled "gang2pc" reservations in an
    :class:`AssumeCache` ledger, folded into every scoring read through
    the core's usage-overlay hook so a prepared-but-undecided gang
    member is invisible to NO placement decision.
    """

    def __init__(
        self,
        shard_id: str,
        api: ApiServerClient,
        informer: Any = None,
        checkpoint: Any = None,
        policy: "str | logic.PlacementPolicy" = "best-fit",
        ledger: AssumeCache | None = None,
    ) -> None:
        self.shard_id = shard_id
        self._api = api
        self._ckpt = checkpoint
        # the configured placement policy, public so the router's
        # gang-group planner scores members with the SAME policy the
        # shard's own verbs use
        self.policy = policy
        self._ledger = ledger if ledger is not None else AssumeCache()
        self._twopc_lock = make_lock("extender.twopc")
        # 2PC side-state, reconstructible from the WAL: ledger key ->
        # {"node", "chips", "units", "epoch", "group", "shape"}. The
        # ledger's reserve_gang entry carries (chip, units) but not the
        # node — this map pins each reservation to the node it protects.
        self._twopc: dict[PodKey, dict[str, Any]] = {}
        self._epochs: dict[str, int] = {}  # group -> highest seen epoch
        # Test hook: a partitioned shard refuses every consultation, the
        # way a network-split real shard would.
        self.partitioned = False
        self.core = ExtenderCore(
            api,
            policy=policy,
            informer=informer,
            checkpoint=checkpoint,
            shard=shard_id,
            usage_overlay_fn=self._twopc_overlay,
        )
        self._owned: dict[str, dict] = {}
        self._summary_cache: tuple[float, dict[str, Any]] | None = None
        self._summary_ttl_s = 0.25
        if checkpoint is not None:
            self._replay_2pc()

    # --- wiring -----------------------------------------------------------

    def set_nodes(self, nodes: Iterable[dict]) -> None:
        """The node objects this shard owns (router-assigned from the
        ring partition; refreshed when the catalog changes)."""
        self._owned = {
            n.get("metadata", {}).get("name", ""): n for n in nodes
        }
        self._summary_cache = None

    def owned_nodes(self) -> list[dict]:
        return list(self._owned.values())

    def owned_node(self, name: str) -> dict | None:
        return self._owned.get(name)

    def _check_reachable(self) -> None:
        if self.partitioned:
            raise ShardUnavailable(f"shard {self.shard_id} partitioned")

    # --- scoring/verbs (router-facing) ------------------------------------

    def batch_scored(self, args: dict) -> dict:
        self._check_reachable()
        return self.core.batch_scored(args)

    def filter(self, args: dict) -> dict:
        self._check_reachable()
        return self.core.filter(args)

    def prioritize(self, args: dict) -> list[dict]:
        self._check_reachable()
        return self.core.prioritize(args)

    def bind(self, args: dict) -> dict:
        self._check_reachable()
        return self.core.bind(args)

    def summary(self) -> dict[str, Any]:
        """Cheap routing summary over the shard's owned nodes — total
        free units and the largest single-chip free block — cached for
        ``_summary_ttl_s`` so the router's per-admission shard ranking
        costs O(1) amortized instead of O(nodes/shard)."""
        self._check_reachable()
        now = time.monotonic()
        cached = self._summary_cache
        if cached is not None and now - cached[0] < self._summary_ttl_s:
            return cached[1]
        free_total = 0
        max_free = 0
        for view in self.core.node_views(
            list(self._owned.values()), const.RESOURCE_MEM
        ):
            for units in view.free().values():
                free_total += units
                if units > max_free:
                    max_free = units
        doc = {
            "shard": self.shard_id,
            "nodes": len(self._owned),
            "free_units": free_total,
            "max_free_chip": max_free,
        }
        self._summary_cache = (now, doc)
        return doc

    # --- 2PC participant ---------------------------------------------------

    @staticmethod
    def twopc_key(group: str, ns: str, name: str) -> PodKey:
        return (GANG2PC_NS, f"{group}/{ns}/{name}")

    def _journal_2pc(self, key: PodKey, data: dict) -> int | None:
        """Journal one gang2pc record (durable before any side effect).
        Returns the begin seq for seq-guarded resolution — callers must
        keep it (resolve it, return it, or store it in the 2PC
        side-state); a discarded seq can never be resolved by anyone."""
        if self._ckpt is None:
            return None
        data = dict(data)
        data["kind"] = WAL_KIND_2PC
        data["ts"] = time.time()
        return self._ckpt.begin(key, data)

    def _resolve_2pc(self, op: str, key: PodKey, seq: int | None) -> None:
        if self._ckpt is None:
            return
        if op == "commit":
            self._ckpt.commit(key, seq=seq)
        else:
            self._ckpt.abort(key, seq=seq)

    def _note_epoch(self, group: str, epoch: int) -> None:
        """Record the highest coordinator epoch seen for ``group``;
        raises :class:`StaleCoordinator` for a lower one."""
        with self._twopc_lock:
            seen = self._epochs.get(group, 0)
            if epoch < seen:
                raise StaleCoordinator(
                    f"shard {self.shard_id}: epoch {epoch} < seen {seen} "
                    f"for group {group}"
                )
            self._epochs[group] = epoch

    def prepare_gang(
        self,
        group: str,
        ns: str,
        name: str,
        node: str,
        chips: Sequence[int],
        per_chip: int,
        shape: str,
        epoch: int,
        coordinator: str,
    ) -> tuple[bool, str]:
        """Phase 1: journal the member's reservation durably, book the
        chips in the ledger as ONE atomic gang entry, then re-validate
        the node inside the booked overlay (the defrag mover's
        reserve-then-check pattern: a plan the world outran aborts
        cleanly instead of over-booking). -> (prepared, reason)."""
        self._check_reachable()
        self._note_epoch(group, epoch)
        key = self.twopc_key(group, ns, name)
        # Claim BEFORE journaling: a same-member re-prepare (a retrying
        # router racing a crashed attempt's pending entry) must fail
        # here without writing — journaling first would overwrite the
        # live attempt's pending record and the claim-failure abort
        # would then pop it, orphaning its reservation journal-less.
        if not self._ledger.claim(key):
            return False, f"{key[1]} already mid-2PC on {self.shard_id}"
        seq = self._journal_2pc(key, {
            "phase": "prepare",
            "group": group,
            "pod_ns": ns,
            "pod_name": name,
            "node": node,
            "chips": [int(c) for c in chips],
            "units": int(per_chip),
            "shape": shape,
            "epoch": epoch,
            "coordinator": coordinator,
        })
        FAULTS.fire("gang2pc.prepare")
        self._ledger.reserve_gang(key, [(int(c), per_chip) for c in chips])
        with self._twopc_lock:
            self._twopc[key] = {
                "node": node, "chips": tuple(int(c) for c in chips),
                "units": int(per_chip), "epoch": epoch, "group": group,
                "shape": shape, "seq": seq, "phase": "prepare",
                "pod_ns": ns, "pod_name": name,
            }
        FAULTS.fire("gang2pc.reserve")
        # Re-validate INSIDE the booked overlay: our own reservation is
        # now counted, so per-chip usage must sit within capacity and no
        # member may be exclusively held. A concurrent admission that
        # landed between the router's plan and this prepare fails the
        # check and the member aborts cleanly.
        node_obj = self._owned.get(node)
        if node_obj is None:
            try:
                node_obj = self._api.get_node(node)
            except ApiError as e:
                self._rollback_member(key, seq)
                return False, f"node {node} unreadable: {e}"
        view = self.core.node_view(node_obj, const.RESOURCE_MEM)
        for c in chips:
            if c in view.core_held or view.used.get(c, 0) > view.capacity.get(c, -1):
                self._rollback_member(key, seq)
                return False, (
                    f"chip {c} on {node} no longer admits {per_chip} "
                    f"units (outrun by a concurrent admission)"
                )
        REGISTRY.counter_inc(
            TWOPC_METRIC, TWOPC_HELP, phase="prepare", outcome="ok",
        )
        return True, ""

    def _rollback_member(
        self, key: PodKey, seq: int | None, drop_epoch: bool = True
    ) -> None:
        """``drop_epoch=False`` is the wedged-coordinator fencing path:
        the resolver seeds a higher fencing epoch BEFORE this rollback,
        and the normal finished-group pruning here would drop that fence
        in the exact window the late-waking driver needs it."""
        self._ledger.release(key)
        with self._twopc_lock:
            entry = self._twopc.pop(key, None)
        if seq is None and entry is not None:
            seq = entry.get("seq")
        if seq is not None:
            # seq-guarded only: an unguarded abort could pop a NEWER
            # same-key begin (a fresh 2PC attempt racing this idempotent
            # re-delivery) — with no seq in hand, leave any pending
            # entry for the reconciler, which resolves with the seq it
            # read from the journal itself
            self._resolve_2pc("abort", key, seq)
        if drop_epoch:
            self._drop_finished_epoch(
                entry.get("group", "") if entry else ""
            )
        REGISTRY.counter_inc(
            TWOPC_METRIC, TWOPC_HELP, phase="abort", outcome="ok",
        )

    def _drop_finished_epoch(self, group: str) -> None:
        """Prune a finished group's fencing epoch once no 2PC side-state
        references it — the epoch only fences an in-flight protocol, and
        an unbounded epoch table would grow with every gang group the
        shard ever saw (the storm mints a fresh group id per burst)."""
        if not group:
            return
        with self._twopc_lock:
            if any(e.get("group") == group for e in self._twopc.values()):
                return
            self._epochs.pop(group, None)

    def commit_gang(
        self, group: str, ns: str, name: str, epoch: int,
        total_request: int = 0,
    ) -> tuple[bool, str]:
        """Phase 2 (commit): persist the member's gang annotations + v1
        Binding from the prepared reservation. The coordinator calls
        this only after its commit decision is durable; the reservation
        stays in the ledger until the watch shows the annotated pod
        (the overlay's visibility release), so there is no window where
        the member is counted nowhere."""
        self._check_reachable()
        self._note_epoch(group, epoch)
        key = self.twopc_key(group, ns, name)
        with self._twopc_lock:
            entry = self._twopc.get(key)
        if entry is None:
            # already committed (idempotent re-delivery), or never
            # prepared here — the apiserver is the arbiter
            try:
                pod = self._api.get_pod(ns, name)
            except ApiError as e:
                return False, f"no prepared entry and pod unreadable: {e}"
            if P.gang_chips_from_annotation(pod):
                return True, ""
            return False, "no prepared entry for member"
        try:
            pod = self._api.get_pod(ns, name)
        except ApiError as e:
            return False, f"pod unreadable at commit: {e}"
        annotations = self._member_annotations(pod, entry, total_request)
        try:
            self._api.patch_pod(
                ns, name, {"metadata": {"annotations": annotations}}
            )
            self._api.bind_pod(ns, name, entry["node"])
        except ApiError as e:
            return False, f"member persist failed: {e}"
        FAULTS.fire("gang2pc.patch")
        self._resolve_2pc("commit", key, entry.get("seq"))
        with self._twopc_lock:
            entry["phase"] = "committed"
            entry["committed_ts"] = time.monotonic()
        FAULTS.fire("gang2pc.commit")
        REGISTRY.counter_inc(
            TWOPC_METRIC, TWOPC_HELP, phase="commit", outcome="ok",
        )
        return True, ""

    def note_committed(self, group: str, ns: str, name: str) -> None:
        """Flip a member's 2PC side-state to committed WITHOUT releasing
        its ledger reservation: the reservation must keep protecting the
        chips until the informer shows the annotated pod (the overlay's
        visibility release) — releasing at resolve time would open the
        same counted-nowhere window the allocator ledger's
        persist->release ordering exists to close."""
        key = self.twopc_key(group, ns, name)
        with self._twopc_lock:
            entry = self._twopc.get(key)
            if entry is not None:
                entry["phase"] = "committed"
                entry["committed_ts"] = time.monotonic()

    def abort_gang(self, group: str, ns: str, name: str, epoch: int) -> bool:
        """Phase 2 (abort): release the member's reservation and resolve
        its journal entry. Idempotent. Unlike commit, abort checks the
        epoch against the ENTRY's own epoch, not the group's highest
        seen: a coordinator fenced mid-prepare must still be able to
        presumed-abort what IT booked (no decision exists, so aborting
        is always safe), while an old coordinator can never abort a
        NEWER attempt's prepare."""
        self._check_reachable()
        key = self.twopc_key(group, ns, name)
        with self._twopc_lock:
            entry = self._twopc.get(key)
        if entry is not None and epoch < int(entry.get("epoch") or 0):
            raise StaleCoordinator(
                f"shard {self.shard_id}: abort epoch {epoch} below the "
                f"prepared entry's {entry.get('epoch')} for {key[1]}"
            )
        self._rollback_member(key, entry.get("seq") if entry else None)
        return True

    def _member_annotations(
        self, pod: dict, entry: dict[str, Any], total_request: int
    ) -> dict[str, str]:
        """The member's one-PATCH gang grant, mirroring
        ``logic.choose_gang_scored``'s annotation shape so the device
        plugin's branch A re-validates it identically."""
        family = logic.RESOURCE_FAMILIES[const.RESOURCE_MEM]
        chips = entry["chips"]
        per_chip = entry["units"]
        request = total_request or P.mem_units_of_pod(pod)
        containers = pod.get("spec", {}).get("containers", [])
        alloc_map: dict[str, dict[str, int]] = {}
        for i, c in enumerate(containers):
            units = P.mem_units_of_container(c, const.RESOURCE_MEM)
            if units <= 0:
                continue
            per = units // len(chips)
            alloc_map[c.get("name", f"c{i}")] = {
                str(idx): per for idx in chips
            }
        # the owned-node map can be empty at recovery time (shards.main
        # runs resolve_gang2pc before the first catalog refresh): fall
        # back to the apiserver so ENV_MEM_DEV carries the real chip
        # capacity — the serving engine sizes its pool from it
        node_obj = self._owned.get(entry["node"])
        if node_obj is None:
            try:
                node_obj = self._api.get_node(entry["node"])
            except ApiError:
                node_obj = {}
        cap = logic.node_capacity(node_obj, const.RESOURCE_MEM) if node_obj else {}
        return {
            const.ENV_GANG_CHIPS: ",".join(str(i) for i in chips),
            const.ENV_GANG_SHAPE: entry.get("shape", str(len(chips))),
            const.ENV_GANG_PER_CHIP: str(per_chip),
            const.ANN_GANG_GROUP: entry.get("group", ""),
            family["pod"]: str(request),
            family["dev"]: str(cap.get(chips[0], 0)),
            family["assigned"]: "false",
            family["assume"]: str(time.time_ns()),
            const.ANN_EXTENDER_ALLOCATION: json.dumps(alloc_map),
        }

    # --- overlay + replay --------------------------------------------------

    def _twopc_overlay(self, node: str, resource: str) -> dict[int, int]:
        """The core's usage-overlay hook: in-flight gang2pc reservations
        for ``node``, with lazy visibility release — once the informer
        shows the committed member's annotated pod on the node, the pod
        source counts it and the reservation is redundant (same
        persist->release window rule as the allocator ledger)."""
        if resource != const.RESOURCE_MEM:
            return {}
        with self._twopc_lock:
            entries = [
                (key, dict(e)) for key, e in self._twopc.items()
                if e.get("node") == node
            ]
        if not entries:
            return {}
        informer = getattr(self.core, "_informer", None)
        now = time.monotonic()
        extra: dict[int, int] = {}
        release: list[PodKey] = []
        for key, entry in entries:
            if entry.get("phase") == "committed":
                if informer is not None:
                    cached = informer.get_pod(
                        entry.get("pod_ns", ""), entry.get("pod_name", "")
                    )
                    # Release only when the index provably counts the pod
                    # ON THIS NODE: the annotation MODIFIED can precede
                    # the bind MODIFIED (nodeName still empty), filing
                    # the pod under node "" — releasing then would leave
                    # the member counted NOWHERE for a window, the
                    # cross-shard double-booking this storm-tested
                    # overlay exists to prevent.
                    if (
                        cached is not None
                        and P.gang_chips_from_annotation(cached)
                        and P.node_name(cached) == node
                    ):
                        release.append(key)
                        continue
                # no visibility signal will ever come for a pod deleted
                # before the watch showed it (or on list-source cores):
                # after the grace, release anyway — the pod source now
                # counts the real pod or the pod is gone
                if (
                    now - float(entry.get("committed_ts") or now)
                    > COMMIT_VISIBILITY_GRACE_S
                ):
                    release.append(key)
                    continue
            for c in entry["chips"]:
                extra[c] = extra.get(c, 0) + entry["units"]
        for key in release:
            self._ledger.release(key)
            with self._twopc_lock:
                released = self._twopc.pop(key, None)
            self._drop_finished_epoch(
                released.get("group", "") if released else ""
            )
        return extra

    def _replay_2pc(self) -> None:
        """Reinstall 2PC reservations from the per-shard WAL at restart:
        a prepared-but-undecided member keeps protecting its chips until
        :func:`resolve_gang2pc` rolls it forward or back — the same
        pending-entry contract as ``replay_checkpoint``."""
        restored = 0
        for key, data in self._ckpt.pending().items():
            if data.get("kind") != WAL_KIND_2PC:
                continue
            if data.get("phase") != "prepare":
                continue
            chips = [int(c) for c in (data.get("chips") or ())]
            units = int(data.get("units") or 0)
            if not chips or units <= 0:
                continue
            self._ledger.claim(key)
            self._ledger.reserve_gang(key, [(c, units) for c in chips])
            with self._twopc_lock:
                self._twopc[key] = {
                    "node": str(data.get("node", "")),
                    "chips": tuple(chips),
                    "units": units,
                    "epoch": int(data.get("epoch") or 0),
                    "group": str(data.get("group", "")),
                    "shape": str(data.get("shape", "")),
                    "seq": data.get("_seq"),
                    "phase": "prepare",
                    "pod_ns": str(data.get("pod_ns", "")),
                    "pod_name": str(data.get("pod_name", "")),
                }
            restored += 1
        if restored:
            log.info(
                "shard %s: %d gang2pc reservation(s) replayed from WAL",
                self.shard_id, restored,
            )

    # --- introspection -----------------------------------------------------

    def twopc_pending(self) -> list[dict[str, Any]]:
        """Pending gang2pc journal entries (prepares AND coordinator
        decisions) from this shard's WAL, for the reconciler and the
        shard-map CLI."""
        if self._ckpt is None:
            return []
        out = []
        for key, data in self._ckpt.pending().items():
            if data.get("kind") != WAL_KIND_2PC:
                continue
            doc = dict(data)
            doc["key"] = list(key)
            out.append(doc)
        return out

    def doc(self) -> dict[str, Any]:
        """One shard's row in the shard map."""
        gangs = self.twopc_pending()
        return {
            "shard": self.shard_id,
            "nodes": len(self._owned),
            "partitioned": self.partitioned,
            "wal_seq": (
                self._ckpt.last_seq if self._ckpt is not None else 0
            ),
            "wal_pending": (
                len(self._ckpt.pending()) if self._ckpt is not None else 0
            ),
            "gangs_inflight": sum(
                1 for g in gangs if g.get("phase") == "prepare"
            ),
        }


# --- router -----------------------------------------------------------------


class ShardRouter:
    """Stateless verb router over the shard set.

    Holds no placement state of its own — ownership is the pure hash
    ring, scoring state lives in the shards, durability in their WALs —
    so any number of router replicas can front the same shards. The
    only router-local state is the cached shard summaries that steer
    the pruned admission fan-out, and those are reconstructible
    cache."""

    def __init__(
        self,
        shards: Sequence[ShardExtender],
        ring: HashRing | None = None,
        fanout: int = 2,
        lease: LeaderLease | None = None,
    ) -> None:
        if not shards:
            raise ValueError("router needs at least one shard")
        self._shards = {s.shard_id: s for s in shards}
        self._ring = ring or HashRing([s.shard_id for s in shards])
        self._fanout = max(1, fanout)
        self._lease = lease or LeaderLease()
        self._lock = make_lock("extender.router")
        self._nodes: dict[str, dict] = {}

    @property
    def ring(self) -> HashRing:
        return self._ring

    @property
    def lease(self) -> LeaderLease:
        """The gang-group coordinator lease. A live reconciler pass MUST
        resolve with this same lease (``resolve_gang2pc(..., lease=
        router.lease)``) so it can tell a live coordinator's undecided
        prepare from a dead one's — rolling back the former re-creates
        the cross-shard double-booking (see :data:`LIVE_PREPARE_GRACE_S`
        and the tpumc counterexample it cites)."""
        return self._lease

    def set_nodes(self, nodes: Iterable[dict]) -> None:
        """Install the node catalog: partitions by ring owner and hands
        each shard its owned node objects."""
        nodes = list(nodes)
        with self._lock:
            self._nodes = {
                n.get("metadata", {}).get("name", ""): n for n in nodes
            }
        owned = self._ring.partition(
            n.get("metadata", {}).get("name", "") for n in nodes
        )
        by_name = {n.get("metadata", {}).get("name", ""): n for n in nodes}
        for sid, shard in self._shards.items():
            shard.set_nodes([by_name[name] for name in owned.get(sid, [])])

    def shard(self, shard_id: str) -> ShardExtender:
        return self._shards[shard_id]

    # --- fan-out verbs -----------------------------------------------------

    def _partitioned_nodes(
        self, nodes: list[dict]
    ) -> dict[str, list[dict]]:
        owned = self._ring.partition(
            n.get("metadata", {}).get("name", "") for n in nodes
        )
        by_name = {n.get("metadata", {}).get("name", ""): n for n in nodes}
        return {
            sid: [by_name[name] for name in names]
            for sid, names in owned.items()
        }

    def batch(self, args: dict, _verb: str = "batch") -> dict:
        """Fan the batch verb out to every owning shard and merge the
        ranked ScoreVector results (wire shape via the SAME
        ``batch_wire`` projection the single core uses — the two
        deployments cannot drift). Unreachable shards degrade: their
        nodes appear in neither ``nodenames`` nor ``failedNodes`` —
        they were never consulted — and the merged decision record (and
        the wire response) names them in ``degraded_shards``. ``_verb``
        labels the decision record when another verb (prioritize)
        delegates here."""
        from .server import batch_wire

        pod = args.get("pod") or {}
        nodes = args.get("nodes", {}).get("items") or []
        meta = pod.get("metadata", {}) if pod else {}
        pod_key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        if logic.pod_resource(pod) is None:
            # not a share pod: everything passes with score 0, exactly
            # like the single extender (a scoreless merge would filter
            # every node out — the scheduler would see it unschedulable)
            names = [n.get("metadata", {}).get("name", "") for n in nodes]
            DECISIONS.emit(
                pod_key, _verb, candidates=len(nodes),
                reason="pod requests no share resource (all nodes pass)",
                shard="router",
            )
            wire = batch_wire({
                "fits": names, "failed": {}, "scores": {},
                "resource": None, "nodes": nodes,
            })
            wire["degraded_shards"] = []
            return wire
        merged_fits: list[str] = []
        merged_failed: dict[str, str] = {}
        merged_scores: dict[str, ScoreVector] = {}
        degraded: list[str] = []
        resource = ""
        for sid, sub_nodes in sorted(self._partitioned_nodes(nodes).items()):
            shard = self._shards[sid]
            try:
                rich = shard.batch_scored(
                    {"pod": pod, "nodes": {"items": sub_nodes}}
                )
            except (ShardUnavailable, ApiError, OSError) as e:
                log.warning("shard %s degraded on %s: %s", sid, _verb, e)
                degraded.append(sid)
                continue
            merged_fits.extend(rich["fits"])
            merged_failed.update(rich["failed"])
            merged_scores.update(rich["scores"])
            resource = rich["resource"] or resource
        DECISIONS.emit(
            pod_key, _verb,
            candidates=len(nodes),
            rejected=merged_failed,
            scores=merged_scores,
            shard="router",
            degraded_shards=degraded,
        )
        fit_set = set(merged_fits)
        wire = batch_wire({
            # fits ranked best-first by the merged RAW scores — the
            # cross-shard half of the deterministic ordering
            "fits": [n for n in rank_scores(merged_scores)
                     if n in fit_set],
            "failed": merged_failed,
            "scores": merged_scores,
            "resource": resource or const.RESOURCE_MEM,
            "nodes": nodes,
        })
        wire["degraded_shards"] = degraded
        return wire

    def filter(self, args: dict) -> dict:
        """Filter fan-out: each owning shard runs its own (score-less)
        filter verb — a two-verb scheduler must not pay the batch
        verb's full scoring pass twice per cycle. Degraded shards'
        nodes are not consulted and reported as such."""
        pod = args.get("pod") or {}
        nodes = args.get("nodes", {}).get("items") or []
        merged_fits: list[str] = []
        merged_failed: dict[str, str] = {}
        degraded: list[str] = []
        for sid, sub_nodes in sorted(self._partitioned_nodes(nodes).items()):
            shard = self._shards[sid]
            try:
                res = shard.filter(
                    {"pod": pod, "nodes": {"items": sub_nodes}}
                )
            except (ShardUnavailable, ApiError, OSError) as e:
                log.warning("shard %s degraded on filter: %s", sid, e)
                degraded.append(sid)
                continue
            merged_fits.extend(res.get("nodenames") or [])
            merged_failed.update(res.get("failedNodes") or {})
        fit_set = set(merged_fits)
        return {
            "nodes": {"items": [
                n for n in nodes
                if n.get("metadata", {}).get("name") in fit_set
            ]},
            "nodenames": merged_fits,
            "failedNodes": merged_failed,
            "degraded_shards": degraded,
            "error": "",
        }

    def prioritize(self, args: dict) -> list[dict]:
        """Prioritize fan-out (the batch machinery, recorded under its
        own verb so ``/decisions?verb=prioritize`` matches the wire)."""
        return self.batch(args, _verb="prioritize")["hostPriorityList"]

    def bind(self, args: dict) -> dict:
        """Route the bind to the node's owner shard — the single writer
        for everything on that node."""
        node = args.get("node", "")
        sid = self._ring.owner(node)
        try:
            return self._shards[sid].bind(args)
        except (ShardUnavailable, OSError) as e:
            return {"error": f"owner shard {sid} unavailable: {e}"}

    # --- pruned admission (the scale hot path) ----------------------------

    def _ranked_shards(self, request_units: int) -> list[ShardExtender]:
        """Shards most likely to admit ``request_units``, best first:
        cached summaries, largest feasible single-chip block first, then
        total free. Degraded shards rank last (still consulted in the
        full-fanout fallback — a partitioned shard heals)."""
        scored: list[tuple[int, int, int, str]] = []
        for sid, shard in self._shards.items():
            try:
                s = shard.summary()
            except (ShardUnavailable, ApiError, OSError):
                scored.append((1, 0, 0, sid))
                continue
            feasible = 0 if s["max_free_chip"] >= request_units else 1
            scored.append(
                (feasible, -s["max_free_chip"], -s["free_units"], sid)
            )
        scored.sort()
        return [self._shards[sid] for _f, _m, _t, sid in scored]

    def admit(self, pod: dict) -> dict[str, Any]:
        """One end-to-end admission: consult the ``fanout`` most
        promising shards' own nodes (batch_scored), pick the best raw
        score across them, bind on the owner. Falls back to a full
        fan-out when the pruned consultation finds nothing — a pod is
        only unschedulable when EVERY reachable shard says so. ->
        ``{"node", "shard", "error", "consulted", "degraded_shards"}``."""
        meta = pod.get("metadata", {})
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        if logic.pod_resource(pod) is None:
            return {
                "node": "", "shard": "",
                "error": "pod requests no share resource",
                "consulted": 0, "degraded_shards": [],
            }
        request = P.mem_units_of_pod(pod)
        ranked = self._ranked_shards(request)
        degraded: list[str] = []
        consulted = 0
        for attempt_set in (ranked[: self._fanout], ranked[self._fanout:]):
            best: tuple[float, str, str] | None = None  # (-raw, node, shard)
            for shard in attempt_set:
                sub_nodes = shard.owned_nodes()
                if not sub_nodes:
                    continue
                try:
                    rich = shard.batch_scored(
                        {"pod": pod, "nodes": {"items": sub_nodes}}
                    )
                except (ShardUnavailable, ApiError, OSError) as e:
                    log.warning(
                        "shard %s degraded on admit: %s", shard.shard_id, e
                    )
                    degraded.append(shard.shard_id)
                    continue
                consulted += 1
                for node_name in rich["fits"]:
                    sv = rich["scores"].get(node_name)
                    if sv is None:
                        continue
                    cand = (-sv.raw, node_name, shard.shard_id)
                    if best is None or cand < best:
                        best = cand
            if best is None:
                continue
            _raw, node_name, sid = best
            result = self._shards[sid].bind({
                "podNamespace": ns, "podName": name, "node": node_name,
                "podObject": pod,
                "nodeObject": self._shards[sid].owned_node(node_name),
            })
            if result.get("error"):
                # the chosen chip was outrun mid-flight; surface the
                # error — the driver retries like a real scheduler would
                return {
                    "node": "", "shard": sid, "error": result["error"],
                    "consulted": consulted, "degraded_shards": degraded,
                }
            return {
                "node": node_name, "shard": sid, "error": "",
                "consulted": consulted, "degraded_shards": degraded,
            }
        return {
            "node": "", "shard": "", "error": "no shard admits the pod",
            "consulted": consulted, "degraded_shards": degraded,
        }

    # --- cross-shard gang groups (two-phase reserve) -----------------------

    def admit_gang_group(self, pods: Sequence[dict]) -> dict[str, Any]:
        """All-or-nothing admission of a gang GROUP (pods sharing
        ``ANN_GANG_GROUP``) whose members land on different nodes and
        shards.

        Plan: place members greedily across shards (each member's
        candidate from its shard's current snapshot, overlaid with the
        group's earlier tentative members). Reserve: leader-elected
        coordinator drives prepare on every member shard — journaled,
        ledger-booked, re-validated. Decide: ONE durable commit/abort
        record on the coordinator's WAL. Commit: members persist their
        gang annotations + Bindings. A failure before the decision
        aborts every prepared member (presumed abort); a crash anywhere
        is resolved by :func:`resolve_gang2pc` with zero partial
        gangs."""
        # a refused group deserves a "why" as much as an admitted one —
        # every exit below emits a decision record (error or per-member)
        if not pods:
            DECISIONS.emit(
                "", "gang-group", outcome="error",
                reason="empty gang group",
            )
            return {"error": "empty gang group", "members": []}
        group = P.gang_group(pods[0])
        meta = pods[0].get("metadata", {})
        first_key = f"{meta.get('namespace', 'default')}/{meta.get('name', '')}"
        if not group or any(P.gang_group(p) != group for p in pods):
            DECISIONS.emit(
                first_key, "gang-group", outcome="error",
                reason="pods do not share one gang-group id",
            )
            return {
                "error": "pods do not share one gang-group id",
                "members": [],
            }
        plan, plan_err = self._plan_group(pods)
        if plan_err:
            DECISIONS.emit(
                first_key, "gang-group", outcome="error",
                reason=plan_err,
            )
            return {"error": plan_err, "members": [], "group": group}
        coordinator_id = self._ring.owner(f"gang-group:{group}")
        epoch = self._lease.acquire(group, coordinator_id)
        coordinator = self._shards[coordinator_id]
        prepared: list[dict[str, Any]] = []
        for member in plan:
            shard = self._shards[member["shard"]]
            try:
                ok, reason = shard.prepare_gang(
                    group, member["ns"], member["name"], member["node"],
                    member["chips"], member["units"], member["shape"],
                    epoch, coordinator_id,
                )
            except (ShardUnavailable, ApiError, OSError) as e:
                ok, reason = False, f"shard {member['shard']} unreachable: {e}"
            except StaleCoordinator as e:
                # a newer coordinator took the group mid-prepare: this
                # incarnation must stop driving, but its prepared prefix
                # still presumed-aborts below (abort accepts an epoch at
                # or above each entry's OWN epoch, so the fenced driver
                # can clean up what IT booked)
                ok, reason = False, f"fenced during prepare: {e}"
            if not ok:
                # presumed abort: no decision record exists, so aborting
                # the prepared prefix (and the failed member's own
                # journal entry, already resolved inside prepare) leaves
                # nothing for the reconciler
                for done in prepared:
                    try:
                        self._shards[done["shard"]].abort_gang(
                            group, done["ns"], done["name"], epoch
                        )
                    except (ShardUnavailable, ApiError, OSError) as e:
                        # the reconciler rolls this undecided prepare
                        # back on its next pass
                        log.warning(
                            "presumed-abort of %s on %s failed: %s",
                            done["name"], done["shard"], e,
                        )
                self._lease.forget(group)
                DECISIONS.emit(
                    f"{member['ns']}/{member['name']}", "gang-group",
                    outcome="error", node=member["node"],
                    reason=f"prepare failed: {reason}",
                    shard=member["shard"],
                )
                return {
                    "error": f"prepare failed for {member['name']}: {reason}",
                    "members": [], "group": group,
                }
            prepared.append(member)
        decision_key = (GANG2PC_NS, f"{group}/decision")
        try:
            # The commit point is epoch-gated: a resolver that overrode
            # this (wedged) coordinator past LIVE_PREPARE_GRACE_S has
            # already rolled its prepares back and seeded a higher
            # fencing epoch — journaling a decision now would roll the
            # group forward onto chips a competing booking may own.
            coordinator._note_epoch(group, epoch)
        except StaleCoordinator as e:
            for done in prepared:
                try:
                    self._shards[done["shard"]].abort_gang(
                        group, done["ns"], done["name"], epoch
                    )
                except (ShardUnavailable, ApiError, OSError,
                        StaleCoordinator):
                    # the fencing resolver already rolled this member
                    # back (or will, next pass)
                    pass
            self._lease.forget(group)
            DECISIONS.emit(
                first_key, "gang-group", outcome="error",
                reason=f"fenced at the decision point: {e}",
            )
            return {
                "error": f"fenced at the decision point: {e}",
                "members": [], "group": group,
            }
        decision_seq = coordinator._journal_2pc(decision_key, {
            "phase": "decision",
            "outcome": "commit",
            "group": group,
            "epoch": epoch,
            "members": [
                {
                    "ns": m["ns"], "name": m["name"], "node": m["node"],
                    "shard": m["shard"], "chips": list(m["chips"]),
                    "units": m["units"], "shape": m["shape"],
                    "request": m["request"],
                }
                for m in plan
            ],
        })
        FAULTS.fire("gang2pc.decide")
        REGISTRY.counter_inc(
            TWOPC_METRIC, TWOPC_HELP, phase="decide", outcome="commit",
        )
        # Decision provenance, per member, once the group's commit record
        # is durable: `inspect why` renders the all-or-nothing GROUP
        # admission — and for a disaggregated two-tier slice, which tier
        # each member serves and the group's tier composition.
        tiers: dict[str, int] = {}
        for m in plan:
            if m.get("tier"):
                tiers[m["tier"]] = tiers.get(m["tier"], 0) + 1
        for m in plan:
            DECISIONS.emit(
                f"{m['ns']}/{m['name']}", "gang-group",
                node=m["node"],
                placement={
                    "group": group,
                    "members": len(plan),
                    "chips": list(m["chips"]),
                    "shape": m["shape"],
                    "per_chip": m["units"],
                    **({"tier": m["tier"]} if m.get("tier") else {}),
                    **({"tiers": tiers} if tiers else {}),
                },
                seq=decision_seq,
                shard=m["shard"],
            )
        errors: list[str] = []
        try:
            for member in plan:
                shard = self._shards[member["shard"]]
                try:
                    ok, reason = shard.commit_gang(
                        group, member["ns"], member["name"], epoch,
                        total_request=member["request"],
                    )
                except (ShardUnavailable, ApiError, OSError,
                        StaleCoordinator) as e:
                    # the decision is durable — a member whose shard
                    # dropped out (or fenced this driver) mid-commit is
                    # the reconciler's to roll forward, never a raised
                    # error: later members still get their commit
                    # attempted now
                    ok, reason = False, str(e)
                if not ok:
                    errors.append(f"{member['name']}: {reason}")
            if errors:
                # the decision is durable: the members that did not
                # commit are the reconciler's to roll forward — the
                # entry stays pending so resolve_gang2pc finds it
                self._lease.forget(group)
                coordinator._drop_finished_epoch(group)
                return {
                    "error": "",
                    "group": group,
                    "members": [m["name"] for m in plan],
                    "pending_rollforward": errors,
                }
            coordinator._resolve_2pc("commit", decision_key, decision_seq)
            FAULTS.fire("gang2pc.done")
            self._lease.forget(group)
            # the decision-point epoch check noted the group on the
            # coordinator shard; a memberless coordinator has no
            # side-state whose release would prune it, so drop it here
            # (no-op while any member side-state still references the
            # group)
            coordinator._drop_finished_epoch(group)
            return {
                "error": "", "group": group,
                "members": [m["name"] for m in plan],
                "pending_rollforward": [],
            }
        finally:
            # group-level outcome record, keyed under the gang pseudo-
            # namespace (member pods keep the reference record shape
            # above): one "why" for the group as a whole, on every exit
            DECISIONS.emit(
                f"gang/{group}", "gang-group",
                reason="; ".join(errors),
                placement={
                    "group": group, "members": len(plan),
                    **({"tiers": tiers} if tiers else {}),
                },
                seq=decision_seq,
            )

    def _plan_group(
        self, pods: Sequence[dict]
    ) -> tuple[list[dict[str, Any]], str]:
        """Greedy cross-shard placement plan for a gang group: each
        member takes the best-scoring feasible slice over ALL shards'
        owned nodes, with earlier members' tentative chips overlaid so
        the plan never self-collides. -> (plan, error)."""
        tentative: dict[str, dict[int, int]] = {}  # node -> chip -> units
        plan: list[dict[str, Any]] = []
        for pod in pods:
            meta = pod.get("metadata", {})
            shape = P.gang_shape_request(pod)
            request = P.mem_units_of_pod(pod)
            if not shape or request <= 0:
                return [], (
                    f"group member {meta.get('name')} has no gang shape "
                    "or no tpu-mem request"
                )
            # pruned like admit(): scan the most-promising shards first
            # and widen to the rest only when nothing fits there
            ranked = self._ranked_shards(request)
            best: tuple[float, str, str, tuple[int, ...], int] | None = None
            for shard_set in (ranked[: self._fanout],
                              ranked[self._fanout:]):
                for shard in shard_set:
                    sid = shard.shard_id
                    try:
                        shard._check_reachable()
                        nodes = shard.owned_nodes()
                    except (ShardUnavailable, OSError):
                        continue
                    if not nodes:
                        continue
                    for view in shard.core.node_views(
                        nodes, const.RESOURCE_MEM
                    ):
                        node_name = view.name
                        for idx, units in tentative.get(
                            node_name, {}
                        ).items():
                            view.used[idx] = view.used.get(idx, 0) + units
                        cand, per_chip, _reason, score = (
                            logic.gang_candidate(
                                view, shape, request, shard.policy
                            )
                        )
                        if cand is None:
                            continue
                        key = (-score.raw, node_name, sid,
                               tuple(cand.chips), per_chip)
                        if best is None or key < best:
                            best = key
                if best is not None:
                    break
            if best is None:
                return [], (
                    f"no feasible placement for group member "
                    f"{meta.get('name')} (shape {shape})"
                )
            _raw, node_name, sid, chips, per_chip = best
            booked = tentative.setdefault(node_name, {})
            for c in chips:
                booked[c] = booked.get(c, 0) + per_chip
            plan.append({
                "ns": meta.get("namespace", "default"),
                "name": meta.get("name", ""),
                "shard": sid,
                "node": node_name,
                "chips": chips,
                "units": per_chip,
                "shape": shape,
                "request": request,
                # disaggregated-serving tier (serving/handoff.py): a
                # two-tier slice is one group — prefill gang + decode
                # gang — and `inspect why` shows the composition
                "tier": P.serving_tier(pod),
            })
        return plan, ""

    # --- introspection -----------------------------------------------------

    def shards_doc(self) -> dict[str, Any]:
        """The ``/shards`` endpoint body: ring ownership, per-shard WAL
        seq + queue depth, and 2PC gangs in flight — what
        ``kubectl-inspect-tpushare shards`` renders."""
        with self._lock:
            node_names = list(self._nodes)
        gangs: list[dict[str, Any]] = []
        rows = []
        for sid in sorted(self._shards):
            shard = self._shards[sid]
            rows.append(shard.doc())
            for entry in shard.twopc_pending():
                gangs.append({
                    "group": entry.get("group", ""),
                    "phase": entry.get("phase", ""),
                    "shard": sid,
                    "node": entry.get("node", ""),
                    "pod": entry.get("pod_name", ""),
                })
        return {
            "ring": self._ring.doc(node_names),
            "fanout": self._fanout,
            "shards": rows,
            "gangs_2pc": gangs,
        }


# --- recovery ---------------------------------------------------------------


def resolve_gang2pc(
    shards: Sequence[ShardExtender],
    api: ApiServerClient,
    lease: LeaderLease | None = None,
) -> dict[str, int]:
    """Resolve every pending "gang2pc" journal entry across ``shards``
    — the reconciler pass a restarted deployment (or a new leader after
    fencing) runs before serving.

    Rules, by phase — the defragmenter's move-protocol discipline:

    - a durable COMMIT decision rolls the group FORWARD: members whose
      pods lack their gang annotations are re-persisted from the
      journaled plan (idempotent — an already-annotated member is left
      alone), then every member entry and the decision resolve;
    - a prepare with NO decision rolls BACK: presumed abort — the
      coordinator never reached its commit point, so the reservation
      releases and the entry aborts;
    - a member whose pod vanished mid-protocol resolves as rolled back
      (nothing to persist to), counted separately.

    Returns counts for tests/telemetry.
    """
    by_id = {s.shard_id: s for s in shards}
    decisions: dict[str, tuple[ShardExtender, dict]] = {}
    prepares: list[tuple[ShardExtender, dict]] = []
    for shard in shards:
        for entry in shard.twopc_pending():
            if entry.get("phase") == "decision":
                decisions[str(entry.get("group", ""))] = (shard, entry)
            elif entry.get("phase") == "prepare":
                prepares.append((shard, entry))
    counts = {
        "rolled_forward": 0, "rolled_back": 0,
        "member_gone": 0, "decisions_resolved": 0,
        "skipped_live": 0,
    }
    # roll forward every decided group
    for group, (coord, decision) in decisions.items():
        epoch = int(decision.get("epoch") or 0)
        new_epoch = (
            lease.acquire(group, coord.shard_id) if lease is not None
            else max(epoch, 1)
        )
        for member in decision.get("members") or []:
            shard = by_id.get(str(member.get("shard", "")))
            ns = str(member.get("ns", "default"))
            name = str(member.get("name", ""))
            if shard is None:
                continue
            key = ShardExtender.twopc_key(group, ns, name)
            try:
                pod = api.get_pod(ns, name)
            except ApiError:
                pod = None
            if pod is None:
                # the member pod vanished mid-protocol: nothing to roll
                # forward to — release whatever the shard still holds
                pending = {
                    tuple(e.get("key") or ()): e
                    for e in shard.twopc_pending()
                }
                entry = pending.get(key)
                shard._rollback_member(
                    key, entry.get("_seq") if entry else None
                )
                counts["member_gone"] += 1
                continue
            if not P.gang_chips_from_annotation(pod):
                ok, reason = shard.commit_gang(
                    group, ns, name, new_epoch,
                    total_request=int(member.get("request") or 0),
                )
                if not ok:
                    # re-prepare-less roll forward: persist directly from
                    # the journaled plan (the shard lost its side-state
                    # in the crash and has no prepared entry)
                    ok = _rollforward_member(shard, group, member, pod)
                if not ok:
                    log.warning(
                        "gang2pc rollforward failed for %s/%s: %s",
                        ns, name, reason,
                    )
                    continue
            else:
                # already persisted: drain the member's journal entry and
                # mark its side-state committed — the ledger reservation
                # drains via the overlay's visibility release, never here
                pending = {
                    tuple(e.get("key") or ()): e
                    for e in shard.twopc_pending()
                }
                entry = pending.get(key)
                if entry is not None:
                    shard._resolve_2pc("commit", key, entry.get("_seq"))
                shard.note_committed(group, ns, name)
            counts["rolled_forward"] += 1
            REGISTRY.counter_inc(
                TWOPC_METRIC, TWOPC_HELP,
                phase="rollforward", outcome="ok",
            )
        coord._resolve_2pc(
            "commit",
            (GANG2PC_NS, f"{group}/decision"),
            decision.get("_seq"),
        )
        if lease is not None:
            lease.forget(group)
        counts["decisions_resolved"] += 1
    # roll back every undecided prepare — UNLESS its coordinator is
    # provably live: the group's lease epoch is still held AND the
    # prepare is younger than LIVE_PREPARE_GRACE_S. A live coordinator
    # is between its prepares and its decision; releasing its member's
    # reservation here lets a competing group book the chips, and the
    # coordinator's (imminent, durable) commit decision then rolls the
    # member forward ON TOP of them — the double-booking tools/tpumc
    # found when the live resolve loop ran lease-less (the pre-fix
    # shards.main wiring; tests/test_tpumc.py replays the schedule).
    # Callers with no lease (startup recovery — no coordinator can be
    # live in a fresh process) roll back immediately, which the
    # kill-at-every-step chaos suite depends on; a wedged live
    # coordinator is overridden once its prepare ages past the grace.
    now = time.time()
    for shard, entry in prepares:
        group = str(entry.get("group", ""))
        if group in decisions:
            continue  # handled (or deliberately left) above
        fence_epoch = 0
        if lease is not None:
            _holder, held_epoch = lease.current(group)
            age = now - float(entry.get("ts") or 0.0)
            if held_epoch > 0:
                if age < LIVE_PREPARE_GRACE_S:
                    counts["skipped_live"] += 1
                    continue
                # Overriding a WEDGED coordinator (lease still held,
                # prepare aged past the grace): take a higher epoch and
                # seed it on the member AND coordinator shards BEFORE
                # anything releases — presumed abort alone is not
                # enough, because the wedged driver may wake later and
                # journal its commit decision on top of whatever
                # re-booked the freed chips; seeding first closes its
                # epoch-gated decision point before the chips free up.
                # The fence (the lease entry and the seeded epochs) is
                # deliberately NEVER pruned on this path: a paused
                # thread can wake arbitrarily late, and pruning would
                # re-open the gate for its stale decision. One retained
                # entry per wedge event — a logged anomaly, not a
                # per-group cost.
                fence_epoch = lease.acquire(group, "gang2pc-resolver")
                shard._note_epoch(group, fence_epoch)
                coord = by_id.get(str(entry.get("coordinator", "")))
                if coord is not None and coord is not shard:
                    coord._note_epoch(group, fence_epoch)
                log.warning(
                    "gang2pc: coordinator for group %s wedged past "
                    "%.0fs with an undecided prepare; fenced at epoch "
                    "%d and rolling the prepare back", group,
                    LIVE_PREPARE_GRACE_S, fence_epoch,
                )
        key = tuple(entry.get("key") or ())
        if len(key) != 2:
            continue
        shard._rollback_member(
            (key[0], key[1]), entry.get("_seq"),
            drop_epoch=not fence_epoch,
        )
        counts["rolled_back"] += 1
        REGISTRY.counter_inc(
            TWOPC_METRIC, TWOPC_HELP, phase="rollback", outcome="ok",
        )
    return counts


def _rollforward_member(
    shard: ShardExtender, group: str, member: dict, pod: dict
) -> bool:
    """Persist one member straight from the journaled decision plan (the
    crash wiped the shard's prepared side-state). Idempotent with the
    normal commit path — same annotation shape, same PATCH."""
    entry = {
        "node": str(member.get("node", "")),
        "chips": tuple(int(c) for c in (member.get("chips") or ())),
        "units": int(member.get("units") or 0),
        "group": group,
        "shape": str(member.get("shape", "")),
    }
    if not entry["chips"] or entry["units"] <= 0:
        return False
    ns = str(member.get("ns", "default"))
    name = str(member.get("name", ""))
    annotations = shard._member_annotations(
        pod, entry, int(member.get("request") or 0)
    )
    try:
        shard._api.patch_pod(
            ns, name, {"metadata": {"annotations": annotations}}
        )
        shard._api.bind_pod(ns, name, entry["node"])
    except ApiError as e:
        log.warning("rollforward PATCH failed for %s/%s: %s", ns, name, e)
        return False
    key = ShardExtender.twopc_key(group, ns, name)
    pending = {
        tuple(e.get("key") or ()): e for e in shard.twopc_pending()
    }
    journal_entry = pending.get(key)
    if journal_entry is not None:
        shard._resolve_2pc("commit", key, journal_entry.get("_seq"))
    shard.note_committed(group, ns, name)
    return True


def main(argv: "list[str] | None" = None) -> int:
    """``tpushare-sharded-extender``: one process hosting N shard cores
    behind the router, speaking the same webhook protocol as the single
    extender (the router's filter/prioritize/batch/bind signatures match
    ``ExtenderCore``'s, so ``ExtenderHTTPServer`` serves it unchanged).
    One informer feeds every shard's own usage index; each shard gets
    its own group-commit bind WAL under ``--checkpoint-dir``. The node
    catalog refreshes from the apiserver every ``--nodes-refresh``
    seconds."""
    import argparse
    import os as _os
    import threading

    from ..allocator.checkpoint import AllocationCheckpoint
    from ..cluster.informer import PodInformer
    from ..utils import log as logutil
    from ..utils.metrics import MetricsServer, publish_build_info
    from .server import ExtenderHTTPServer, wait_for_stop

    p = argparse.ArgumentParser(prog="tpushare-sharded-extender")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--fanout", type=int, default=2,
                   help="shards consulted per pruned admission before "
                   "the full fan-out fallback")
    p.add_argument("--port", type=int, default=32766)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--policy", default="best-fit",
                   choices=["first-fit", "best-fit", "spread"])
    p.add_argument("--placement-policy", default="",
                   help="pluggable placement policy (greedy-binpack | "
                   "multi-objective | learned | registered); overrides "
                   "--policy")
    p.add_argument("--checkpoint-dir", default="",
                   help="directory for the per-shard bind WALs "
                   "(shard-N.wal); empty disables journaling")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics + /shards (the shard map the "
                   "inspect CLI reads) on this port (0 = off)")
    p.add_argument("--nodes-refresh", type=float, default=10.0)
    p.add_argument("--gang2pc-resolve-interval", type=float, default=30.0,
                   help="seconds between reconciler passes over pending "
                   "gang2pc journal entries (0 disables; one pass "
                   "always runs at start)")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("-v", "--verbosity", type=int, default=0)
    args = p.parse_args(argv)
    logutil.setup(args.verbosity)
    # fault injection (TPUSHARE_FAULTS="gang2pc.commit=crash:1,..."), as the
    # node agent's daemon arms it: the crash drill of a live router process
    if FAULTS.install_from_env():
        log.warning("fault injection ACTIVE at points: %s", FAULTS.active())
    try:
        api = ApiServerClient.from_env(timeout_s=args.timeout)
    except Exception as e:  # noqa: BLE001 — startup config, fatal
        log.fatal(f"apiserver config failed: {e}")
    informer = PodInformer(api).start()
    policy: "str | logic.PlacementPolicy" = args.policy
    if args.placement_policy:
        from .policy import get_policy

        policy = get_policy(args.placement_policy)
    shards = []
    for i in range(max(1, args.shards)):
        checkpoint = None
        if args.checkpoint_dir:
            _os.makedirs(args.checkpoint_dir, exist_ok=True)
            checkpoint = AllocationCheckpoint(
                _os.path.join(args.checkpoint_dir, f"shard-{i}.wal")
            )
        shards.append(ShardExtender(
            f"shard-{i}", api, informer=informer,
            checkpoint=checkpoint, policy=policy,
        ))
    # ONE lease shared by the router and every resolve pass: the live
    # resolve loop must see which groups a live coordinator is still
    # driving (resolve_gang2pc's live-prepare gate) — a lease-less
    # resolve racing admit_gang_group was the tpumc-found double-booking
    lease = LeaderLease()
    router = ShardRouter(shards, fanout=args.fanout, lease=lease)
    # inherited 2PC state first: a fresh process has no live
    # coordinators, so every undecided prepare legitimately rolls back
    resolve_gang2pc(shards, api, lease)

    def refresh_nodes() -> None:
        while True:
            try:
                router.set_nodes(api.list_nodes())
            except ApiError as e:
                log.warning("node catalog refresh failed: %s", e)
            time.sleep(args.nodes_refresh)

    def resolve_loop() -> None:
        # the live-process healing pass: a coordinator that died between
        # a member's prepare and its own decision leaves pending entries
        # only the reconciler resolves — once at start is not enough for
        # a long-lived deployment
        while True:
            time.sleep(args.gang2pc_resolve_interval)
            try:
                resolve_gang2pc(shards, api, lease)
            except ApiError as e:
                log.warning("gang2pc resolve pass failed: %s", e)

    threading.Thread(
        target=refresh_nodes, daemon=True, name="shard-nodes"
    ).start()
    if args.gang2pc_resolve_interval > 0:
        threading.Thread(
            target=resolve_loop, daemon=True, name="gang2pc-resolve"
        ).start()
    metrics_server = None
    if args.metrics_port:
        publish_build_info(component="sharded-extender")
        metrics_server = MetricsServer(
            port=args.metrics_port,
            ready_fn=lambda: bool(informer.synced),
            shards_doc_fn=router.shards_doc,
        ).start()
        log.info("metrics + /shards on :%d", metrics_server.port)
    server = ExtenderHTTPServer(router, host=args.host, port=args.port)
    server.start()
    try:
        wait_for_stop()
    except KeyboardInterrupt:
        pass
    server.stop()
    informer.stop()
    if metrics_server is not None:
        metrics_server.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - thin process entry
    import sys

    sys.exit(main())
