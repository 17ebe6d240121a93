"""Fleet binding: N paged engines behind the router, co-simulated.

Counterpart of ``gpushare_device_plugin_tpu/serving/fleet.py``.
``serving/router.py`` is the protocol half (routing table, membership,
journaled scale-down); this module binds it to real
:class:`~.engine.PagedSlotEngine` instances, the way ``handoff.py`` binds
``handoffproto.py`` to a prefill/decode pair. One :class:`FleetServer`
owns a pool of engines, a :class:`~.router.FleetMembership` scraping each
engine's exported doc (free slots, queue depth, radix prefix
fingerprints), a :class:`~.router.FleetRouter`, and a
:class:`~.router.ScaleExecutor` whose side-effect hooks are this
module's methods.

``serve`` is a co-simulation: the trace is routed request by request in
arrival order (affinity fingerprints and load estimates updating as it
goes), then each engine serves its sub-trace, one engine after another.
Three failure drills ride the same entry point:

- **scale-down** (``scale_down=(victim, at_tick)``): the victim drains
  at the tick mid-trace through the journaled cordon -> drain -> migrate
  -> release protocol; its unfinished requests restore onto a survivor
  (``snapshot_id``-deduped) with the tokens of an undisturbed run.
- **engine death** (``kill_engine=(victim, at_tick)``): the victim's
  snapshot dies with it; the ROUTER's in-flight table is the recovery
  source: unfinished requests re-queue as fresh admissions on survivors
  (a full re-prefill; greedy tokens are the same), none dropped.
- **router restart** (``restart_router_after=k``): the routing table is
  a cache of the engines' ground truth; a fresh router seeds its
  in-flight table from the buckets already committed and keeps routing.

The reconciler hooks (:meth:`FleetServer.scale_deliver` /
:meth:`FleetServer.scale_requeue`) resolve a scale WAL entry found after
a crash through :func:`~.router.resolve_scale`: roll-forward re-delivers
the journaled snapshot to a survivor, roll-back re-opens the replica or
re-queues the journaled rows; either way every request is served exactly
once.

A request row (the drain record's, and every re-queue's) carries the
request's ``adapter_id``, so a LoRA tenant's request that outlives its
engine re-prefills and decodes under its own adapter on the survivor.
The reference's rows carry none, and its re-queued tenant rows run under
the base model (``ROADMAP.md`` §3 fault 7); it ignores the extra key, so
a scale journal written by either package loads in the other.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

from ..const import FLEET_REPLICA_DRAINING
from ..utils.decisions import DECISIONS, DecisionLog
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY, MetricsRegistry
from ..utils.slo import SloBudget
from .engine import PagedSlotEngine, Request, ServeStats
from .router import (
    EngineScrapeClient,
    FleetMembership,
    FleetRouter,
    ScaleExecutor,
)

log = get_logger("serving.fleet")


class FleetServer:
    """A pool of paged engines behind the prefix-affinity router."""

    def __init__(
        self,
        engines: Mapping[str, PagedSlotEngine],
        *,
        checkpoint: Any = None,
        assume: Any = None,
        policy: str = "prefix-affinity",
        slo_budget: SloBudget | None = None,
        shed_queue_depth: int = 64,
        miss_threshold: int = 3,
        decisions: DecisionLog = DECISIONS,
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
        node: str = "",
    ) -> None:
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.engines: dict[str, PagedSlotEngine] = dict(engines)
        first = next(iter(self.engines.values()))
        self.page_size = first.page_size
        self.membership = FleetMembership(
            miss_threshold=miss_threshold, registry=registry, pod=pod
        )
        for name, eng in sorted(self.engines.items()):
            # frozen clock + no-op sleep: the co-simulated scrape is
            # in-process and deterministic
            client = EngineScrapeClient(
                lambda n=name: self.scrape_doc(n),
                sleep=lambda s: None,
                clock=lambda: 0.0,
            )
            self.membership.add(name, client, capacity=eng.n_slots)
        self.router = FleetRouter(
            self.membership,
            page_size=self.page_size,
            policy=policy,
            slo_budget=slo_budget,
            shed_queue_depth=shed_queue_depth,
            decisions=decisions,
            registry=registry,
            pod=pod,
        )
        self.executor = ScaleExecutor(
            checkpoint, assume,
            cordon_fn=self._cordon,
            rows_fn=self._frozen_rows,
            drain_fn=self._drain_victim,
            migrate_fn=self._migrate_snapshot,
            release_fn=self._release_victim,
            node=node, registry=registry, pod=pod,
        )
        self._decisions = decisions
        self._registry = registry
        self._pod = pod
        # accumulated across serve()/resolve passes — the exactly-once
        # ledger the chaos gates assert on
        self.results: dict[int, dict] = {}
        self.double_served: list[int] = []
        self.shed: list[int] = []
        self._requests: dict[int, Request] = {}
        self._buckets: dict[str, list[Request]] = {}
        self._scale_tick: int | None = None

    # --- the per-engine exported doc (the /fleet scrape plane) ------------

    def scrape_doc(self, name: str) -> dict[str, Any]:
        """One engine's membership doc: headroom + prefix fingerprints.
        Raises when the replica is gone — a scrape miss, which is the
        failure detector's signal, not an error to hide."""
        eng = self.engines.get(name)
        if eng is None:
            raise LookupError(f"fleet replica {name} is gone")
        fps = eng.radix.fingerprints() if eng.radix is not None else []
        return {
            "free_slots": eng.n_slots,
            "capacity": eng.n_slots,
            "queue_depth": 0,
            "fingerprints": fps,
            "page_size": eng.page_size,
        }

    def fleet_doc(self) -> dict[str, Any]:
        """The fleet's document (the reference CLI's ``render_fleet``
        renders it): replica map, router outcomes, scale state, and the
        global prefix-hit ratio."""
        return {
            "replicas": self.membership.doc()["replicas"],
            "router": self.router.doc(),
            "scale": {
                "ops": self.executor.completed_ops,
                "migrated_requests": self.executor.migrated_requests,
            },
            "prefix_hit_ratio": round(self.prefix_hit_ratio(), 4),
        }

    def prefix_hit_ratio(self) -> float:
        """Fleet-global radix hit ratio: summed hit tokens over summed
        lookup tokens across every engine (not an average of ratios —
        a busy engine weighs more)."""
        hit = looked = 0
        for eng in self.engines.values():
            if eng.radix is not None:
                hit += eng.radix.hit_tokens
                looked += eng.radix.lookup_tokens
        return hit / looked if looked else 0.0

    # --- serve: route, then run ------------------------------------------

    def serve(
        self,
        requests: Sequence[Request],
        *,
        scale_down: tuple[str, int] | None = None,
        kill_engine: tuple[str, int] | None = None,
        restart_router_after: int | None = None,
        scale_id: str = "scale-0",
    ) -> dict:
        """Route the trace and serve it across the pool; see the module
        docstring for the three failure drills. Returns the merged
        result doc (rid -> tokens/latency/engine/path, shed and dropped
        lists, router/membership docs)."""
        self.membership.scrape_once()
        incoming = sorted(requests, key=lambda r: (r.arrival, r.rid))
        for i, r in enumerate(incoming):
            if restart_router_after is not None and i == restart_router_after:
                self._restart_router()
            self._requests[r.rid] = r
            d = self.router.route(str(r.rid), r.prompt, r.tier)
            if d.engine is None:
                if d.shed:
                    self.shed.append(r.rid)
                    continue
                raise RuntimeError(
                    f"request {r.rid} unroutable: {d.reason}"
                )
            self._buckets.setdefault(d.engine, []).append(r)
        if scale_down is not None:
            victim, at_tick = scale_down
            self._scale_tick = at_tick
            self.executor.execute(scale_id, victim)
            self._scale_tick = None
        elif kill_engine is not None:
            self._kill_engine(*kill_engine)
        for name in sorted(self._buckets):
            bucket = self._buckets.pop(name)
            if not bucket:
                continue
            eng = self.engines.get(name)
            if eng is None:
                # released mid-serve (scale-down raced a late bucket)
                self._requeue_rows(
                    [self._row_of(r) for r in bucket], path="requeued"
                )
                continue
            stats = eng.run(bucket)
            self._record(stats, name, "fleet")
        self.membership.scrape_once()
        self.membership.publish()
        return self._finish(incoming)

    def _restart_router(self) -> None:
        """Replace the router mid-trace (crash drill): the new table
        seeds from the engines' ground truth — here, the buckets of
        requests already committed to an engine."""
        self.router = FleetRouter(
            self.membership,
            page_size=self.page_size,
            policy=self.router._policy,
            slo_budget=self.router._slo,
            shed_queue_depth=self.router._shed_queue_depth,
            decisions=self._decisions,
            registry=self._registry,
            pod=self._pod,
        )
        self.router.seed_inflight({
            str(r.rid): name
            for name, bucket in self._buckets.items()
            for r in bucket
        })

    def _row_of(self, r: Request) -> dict:
        return {
            "rid": r.rid,
            "state": "queued",
            "prompt": list(r.prompt),
            "max_new": r.max_new,
            "arrival": float(r.arrival),
            "tier": r.tier,
            "slo_ttft_ticks": r.slo_ttft_ticks,
            "slo_tpot_ticks": r.slo_tpot_ticks,
            "adapter_id": r.adapter_id,
            "tokens": [],
        }

    def _record(self, stats: ServeStats, engine: str, path: str) -> None:
        for res in stats.results:
            start = res.arrival_tick
            req = self._requests.get(res.rid)
            if req is not None:
                start = req.arrival
            n = len(res.tokens)
            entry = {
                "tokens": list(res.tokens),
                "ttft_ticks": (
                    res.first_token_tick - float(start)
                    if res.first_token_tick >= 0 else None
                ),
                "tpot_ticks": (
                    (res.finish_tick - float(start)) / (n - 1)
                    if n > 1 and res.finish_tick >= 0 else None
                ),
                "engine": engine,
                "path": path,
            }
            if res.rid in self.results:
                self.double_served.append(res.rid)
                log.warning("fleet served rid %d twice", res.rid)
            self.results[res.rid] = entry
            self.router.complete(str(res.rid))

    def _finish(self, requests: Sequence[Request]) -> dict:
        admitted = [r for r in requests if r.rid not in self.shed]
        dropped = [
            r.rid for r in admitted
            if r.rid not in self.results
            or not self.results[r.rid]["tokens"]
        ]
        if dropped:
            log.warning("fleet serve dropped rids %s", dropped)
        return {
            "results": dict(self.results),
            "shed": list(self.shed),
            "dropped": dropped,
            "double_served": list(self.double_served),
            "router": self.router.doc(),
            "replicas": self.membership.doc()["replicas"],
            "prefix_hit_ratio": self.prefix_hit_ratio(),
        }

    # --- scale-down side-effect hooks (ScaleExecutor) ---------------------

    def _cordon(self, victim: str) -> None:
        self.membership.cordon(victim)

    def _frozen_rows(self, victim: str) -> list[dict]:
        """The victim's frozen in-flight set, post-cordon: everything
        routed to it and not yet served (JSON-safe — it goes straight
        into the drain record)."""
        return [
            self._row_of(r)
            for r in self._buckets.get(victim, ())
            if r.rid not in self.results
        ]

    def _drain_victim(self, victim: str) -> dict:
        self.membership.set_state(victim, FLEET_REPLICA_DRAINING)
        eng = self.engines[victim]
        bucket = self._buckets.pop(victim, [])
        stats = eng.run(bucket, drain_at_tick=self._scale_tick)
        self._record(stats, victim, "drained")
        return eng.drain_snapshot() or {}

    def _migrate_snapshot(self, snapshot: dict, record: dict) -> int:
        rows = (snapshot or {}).get("requests") or []
        if not rows:
            return 0
        survivor = self.router.least_loaded(
            exclude={str(record.get("engine") or "")}
        )
        if survivor is None:
            raise RuntimeError(
                "scale migrate: no ready survivor — entry stays pending"
            )
        stats = self.engines[survivor].restore_snapshot(snapshot)
        self._record(stats, survivor, "migrated")
        for row in rows:
            self.router.complete(str(row["rid"]))
        return len(rows)

    def _release_victim(self, victim: str) -> None:
        self.membership.mark_dead(victim)
        self.router.forget_engine(victim)
        self.engines.pop(victim, None)

    # --- reconciler hooks (resolve_scale's side effects) ------------------

    def scale_deliver(self, scale_id: str, record: dict) -> None:
        """Roll-forward: re-deliver the journaled snapshot to a
        survivor (idempotent — restore dedups by snapshot_id) and
        finish the release the dead executor never reached."""
        self._migrate_snapshot(record.get("snapshot") or {}, record)
        victim = str(record.get("engine") or "")
        if victim:
            self._release_victim(victim)

    def scale_requeue(self, scale_id: str, record: dict) -> None:
        """Roll-back: the replica re-opens if it still lives; a dead
        one's journaled rows re-queue on survivors (rid-deduped against
        already-served results — full re-prefill, tokens bit-identical
        by greedy determinism)."""
        victim = str(record.get("engine") or "")
        if victim in self.engines:
            self.membership.uncordon(victim)
            return
        self._requeue_rows(record.get("rows") or [], path="requeued")

    # --- engine death ------------------------------------------------------

    def _kill_engine(self, victim: str, at_tick: int) -> None:
        """Simulate the victim dying mid-decode: results already
        streamed count as served; its KV (and any would-be snapshot)
        dies with it. Recovery is the router's in-flight table: every
        unfinished request re-queues as a fresh admission on the
        survivors."""
        eng = self.engines.pop(victim)
        bucket = self._buckets.pop(victim, [])
        stats = eng.run(bucket, drain_at_tick=at_tick)
        self._record(stats, victim, "fleet")
        self.membership.mark_dead(victim)
        rids = self.router.forget_engine(victim)
        rows = [
            self._row_of(self._requests[int(rid)])
            for rid in rids
            if int(rid) in self._requests
            and int(rid) not in self.results
        ]
        log.warning(
            "fleet replica %s died at tick %d; re-queueing %d in-flight "
            "requests on survivors", victim, at_tick, len(rows),
        )
        self._requeue_rows(rows, path="requeued")

    def _requeue_rows(self, rows: Sequence[dict], path: str) -> None:
        """Re-admit journaled/forgotten rows on live replicas, deduped
        by rid against everything already served."""
        groups: dict[str, list[Request]] = {}
        for row in rows:
            rid = int(row["rid"])
            if rid in self.results:
                continue
            req = Request(
                rid=rid,
                prompt=tuple(int(t) for t in row["prompt"]),
                max_new=int(row["max_new"]),
                arrival=0.0,  # re-queued requests have already arrived
                tier=str(row.get("tier") or "critical"),
                slo_ttft_ticks=row.get("slo_ttft_ticks"),
                slo_tpot_ticks=row.get("slo_tpot_ticks"),
                adapter_id=str(row.get("adapter_id") or ""),
            )
            self._requests.setdefault(rid, req)
            d = self.router.route(str(rid), req.prompt, req.tier)
            if d.engine is None:
                raise RuntimeError(
                    f"requeue of rid {rid} unroutable: {d.reason}"
                )
            groups.setdefault(d.engine, []).append(req)
        for name in sorted(groups):
            stats = self.engines[name].run(groups[name])
            self._record(stats, name, path)
