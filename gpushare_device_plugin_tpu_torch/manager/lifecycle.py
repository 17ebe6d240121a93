"""Daemon lifecycle manager.

Counterpart of ``gpushare_device_plugin_tpu/manager/lifecycle.py``
(upstream: ``sharedGPUManager.Run``, ``gpumanager.go:33-108``):

- park forever (never crash-loop) on nodes without cards,
- serve the device plugins (``tpu-mem`` fan-out and whole-card
  ``tpu-core``),
- feed the health watcher into both plugins and the allocator, so binpack
  and core holds route around sick cards,
- rebuild and re-register when kubelet restarts (plugin-dir watcher) or
  on SIGHUP,
- SIGQUIT dumps all-thread stacks to a file, SIGUSR1 a flight record,
- SIGTERM/SIGINT quiesce every plugin, drain in-flight Allocate calls
  against one deadline, then stop.

Standalone mode accounts grants in one in-process ``LocalAllocator`` and
never reclaims them. Cluster mode (an apiserver client and a pod source)
admits the pods the scheduler extender assumed through
``ClusterAllocator`` and ``ClusterCoreAllocator`` over one shared
``AssumeCache``, journals each admission to the WAL checkpoint before its
annotation PATCH, patches the node's chip count and reads its isolation
label at every (re)build, claims the fence and replays unresolved journal
entries before the plugins serve, posts health transitions as node
events, and runs the drift reconciler, whose first pass resolves what the
replay re-reserved. A deleted pod's units come back with it, since the
annotations are the ledger. Beside the reconciler run the node's loops:
live defragmentation (``--defrag-interval``: the planner and the journaled
mover, whose engine hand-off a serving integration registers through
:meth:`TpuShareManager.set_move_hooks`), the interference detector
(``--interference-interval``) and the cluster-state timeline sampler
(``--timeline-interval``, on by default).

This module imports no grpc when it loads: the plugin server is imported
where plugins are built, so the inventory, the allocators and the health
sink build and run on a host without grpc.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Sequence

from .. import const
from ..allocator.assume import AssumeCache
from ..allocator.checkpoint import AllocationCheckpoint, replay_checkpoint
from ..allocator.env import build_core_allocation
from ..allocator.local import LocalAllocator
from ..device.fanout import DeviceInventory
from ..discovery.base import ChipHealth, DiscoveryBackend
from ..utils.faults import FAULTS
from ..utils.log import get_logger
from ..utils.metric_catalog import SLO_BURN_RATE
from ..utils.stacktrace import coredump
from .health import HealthWatcher
from .watchers import PluginDirWatcher

log = get_logger("manager")


@dataclasses.dataclass
class ManagerConfig:
    plugin_dir: str = const.DEVICE_PLUGIN_PATH
    node_name: str = ""
    memory_unit: const.MemoryUnit = const.MemoryUnit.GiB
    policy: str = "first-fit"
    health_check: bool = False
    # No apiserver: LocalAllocator accounting. Without the apiserver there
    # is no pod-lifecycle feed, so allocations are never reclaimed until
    # the daemon restarts (a rebuild starts a fresh allocator).
    standalone: bool = False
    serve_core_resource: bool = True
    disable_isolation: bool = False
    coredump_dir: str = "/etc/kubernetes"
    # Write-ahead allocation journal (allocator/checkpoint.py). Empty
    # disables it; cluster mode should point it at a path that survives
    # container restarts (the device-plugin dir is the natural hostPath).
    checkpoint_path: str = ""
    # WAL durability mode: "batch" (group commit: one fsync covers every
    # record queued within the gather window) or "always" (fsync per
    # record). Durability semantics are identical; see --wal-fsync.
    wal_fsync: str = "batch"
    wal_batch_window_s: float = 0.002
    # Coalesce concurrently-committed pod-annotation PATCHes through one
    # pipelined dispatcher (cluster/apiserver.py PodPatchPipeline).
    patch_coalesce: bool = True
    # Drift-reconciler cadence (cluster/reconciler.py); <= 0 disables.
    reconcile_interval_s: float = 30.0
    # How long graceful shutdown waits for in-flight Allocate calls.
    drain_timeout_s: float = 5.0
    # Flight-recorder dump directory (utils/flightrec.py): SIGUSR1, fatal
    # exit and injected-crash postmortems land here. Empty disables (the
    # daemon defaults it to the coredump dir). flightrecord_keep bounds
    # the directory to the newest K dump files (0 = unbounded).
    flightrecord_dir: str = ""
    flightrecord_keep: int = 16
    # Interference detector cadence (cluster/interference.py): every
    # interval the daemon correlates per-card co-residency with step-p99
    # inflation and publishes the interference node annotation and ratio
    # gauges; <= 0 disables (opt-in, so nodes without serving engines pay
    # nothing).
    interference_interval_s: float = 0.0
    interference_threshold: float = 1.25
    # Serving pods' /metrics endpoints to scrape for the engines' step p99
    # gauges. Empty: the loop reads the shared in-process registry, which
    # only sees engines that feed it (co-located integrations); per-pod
    # engines need their endpoints listed.
    interference_scrape_urls: tuple[str, ...] = ()
    # Live slice defragmentation (allocator/defrag.py): scan cadence in
    # seconds, <= 0 disables (the default: repacking moves workloads and is
    # an explicit operator opt-in). quantum=0 auto-derives the
    # stranded-sliver threshold from the node's own pod sizes.
    defrag_interval_s: float = 0.0
    defrag_quantum: int = 0
    defrag_max_moves: int = 8
    # Cluster-state timeline sampler (utils/timeline.py): every interval the
    # daemon folds utilization, stranded %, pending depth and SLO burn into
    # the bounded ring served on /timeline and embedded in flight records.
    # One chip_state read a tick, so on by default; <= 0 disables.
    timeline_interval_s: float = 10.0
    # Decision-provenance ring (utils/decisions.py), served on /decisions.
    # 0 disables emission.
    decisions_ring: int = 512
    decisions_log_path: str = ""


class TpuShareManager:
    def __init__(
        self,
        backend: DiscoveryBackend,
        config: ManagerConfig,
        api_client=None,
        pod_source=None,
    ):
        self._backend = backend
        self._cfg = config
        self._api = api_client
        self._pod_source = pod_source
        # cluster mode: the apiserver is the database and the allocators
        # persist every decision there
        self._cluster = api_client is not None and not config.standalone
        self._plugins: list = []  # plugin.server.TpuSharePlugin, built in _serve_all
        self._health: HealthWatcher | None = None
        self._events = None  # NodeEventEmitter in cluster mode with health
        self._local: LocalAllocator | None = None  # standalone accounting
        # effective isolation toggle: config flag OR node label, re-read at
        # every plugin (re)build (upstream: podmanager.go:59-72 read at
        # server.go:60-74)
        self._disable_isolation = config.disable_isolation
        # One reservation ledger across the mem and core allocators: both
        # resources share one physical-card ledger, so their in-flight
        # claims and reservations must be mutually visible.
        self._alloc_assume = AssumeCache()
        # Crash-safe state (cluster mode): the WAL the allocators journal
        # through, and the drift reconciler that keeps annotations, ledger,
        # checkpoint and kubelet coherent.
        self._ckpt: AllocationCheckpoint | None = None
        if config.checkpoint_path and self._cluster:
            try:
                self._ckpt = AllocationCheckpoint(
                    config.checkpoint_path,
                    fsync=config.wal_fsync,
                    batch_window_s=config.wal_batch_window_s,
                )
            except OSError as e:
                log.warning(
                    "allocation checkpoint unavailable (%s); running "
                    "unjournaled: restart recovery degraded", e,
                )
        # Coalesced admission writes: both allocators route their pod
        # PATCHes through one group-commit dispatcher, so a storm of
        # concurrent admissions batches its apiserver round-trips.
        self._patch_pipeline = None
        if config.patch_coalesce and self._cluster:
            from ..cluster.apiserver import PodPatchPipeline

            self._patch_pipeline = PodPatchPipeline(api_client)
        self._reconciler = None
        # The node's loops (cluster mode), built with the plugins: live
        # defragmentation, the interference detector and the timeline
        # sampler.
        self._defrag = None  # allocator.defrag.DefragLoop
        self._interference = None  # cluster.interference.InterferenceLoop
        self._timeline_loop = None  # utils.timeline.TimelineLoop
        # The defragmenter's engine hand-off, registered by a serving
        # integration (set_move_hooks); None means moves skip the drain and
        # restore phases (workloads that checkpoint themselves).
        self._move_drain_fn = None
        self._move_restore_fn = None
        # Decision-provenance configuration applies process-wide (the
        # allocators emit through the module singleton).
        from ..utils.decisions import DECISIONS

        DECISIONS.configure(
            enabled=config.decisions_ring > 0,
            max_records=max(1, config.decisions_ring),
            segment_path=config.decisions_log_path,
        )
        self._restart = threading.Event()
        self._stop = threading.Event()
        self._park = threading.Event()
        self._parked = False  # no-card node: healthy, serving nothing

    def ready(self) -> bool:
        """Daemon readiness for the metrics server's ``/readyz``: every
        served plugin has completed kubelet registration (an unregistered
        plugin serves no pods, whatever its socket says). A parked daemon
        (no cards on the node) reads ready: it is healthy and
        intentionally serving nothing."""
        if self._parked:
            return True
        plugins = list(self._plugins)
        return bool(plugins) and all(p.registered for p in plugins)

    def set_move_hooks(self, drain_fn=None, restore_fn=None) -> None:
        """Register the defragmenter's engine hand-off: ``drain_fn(pod_key)
        -> snapshot dict | None`` quiesces the pod's serving engine
        (``PagedSlotEngine.drain_snapshot``), ``restore_fn(pod_key,
        snapshot)`` re-admits it on the destination slice. Takes effect at
        once: the mover and the reconciler dispatch through the manager and
        read the current hooks at call time, so hooks registered after the
        build (the engine exists only once a pod is served) still cover a
        move the reconciler resolves."""
        self._move_drain_fn = drain_fn
        self._move_restore_fn = restore_fn

    def _move_drain_dispatch(self, pod_key):
        fn = self._move_drain_fn
        return None if fn is None else fn(pod_key)

    def _move_restore_dispatch(self, pod_key, snapshot) -> None:
        fn = self._move_restore_fn
        if fn is None:
            if snapshot:
                # A drained snapshot with no restore hook must not be
                # dropped: raising means retry-next-pass in both
                # resolve_move and SliceMover, so the journaled requests
                # survive until the serving integration registers.
                raise RuntimeError(
                    "drained engine snapshot present but no restore hook "
                    "registered (set_move_hooks)"
                )
            return
        fn(pod_key, snapshot)

    # ------------------------------------------------------------------

    def _build_inventory(self) -> DeviceInventory | None:
        FAULTS.fire("discovery.probe")
        if not self._backend.probe():
            return None
        chips = self._backend.chips()
        if not chips:
            return None
        return DeviceInventory(chips, unit=self._cfg.memory_unit)

    def _build_allocator(self, inventory: DeviceInventory, unhealthy_fn):
        """The mem plugin's allocate function: ``ClusterAllocator`` in
        cluster mode (it reads ``unhealthy_fn``, the plugin's live health
        view), else one ``LocalAllocator``, whose health view the watcher
        feeds through :meth:`_local_sink`."""
        if not self._cluster:
            log.warning(
                "standalone mode: allocations are accounted in-process and "
                "never reclaimed on pod deletion (dev/bench only)"
            )
            self._local = LocalAllocator(
                inventory,
                policy=self._cfg.policy,
                disable_isolation=self._disable_isolation,
            )
            local = self._local
            return lambda granted: local.allocate([len(g) for g in granted])
        from ..allocator.cluster import ClusterAllocator

        cluster = ClusterAllocator(
            inventory,
            self._api,
            self._pod_source,
            self._cfg.node_name,
            policy=self._cfg.policy,
            disable_isolation=self._disable_isolation,
            unhealthy_chips_fn=unhealthy_fn,
            assume=self._alloc_assume,
            checkpoint=self._ckpt,
            patcher=self._patcher(),
            chip_topology=self._node_chip_topology(inventory),
        )
        return cluster.allocate

    def _patcher(self):
        return self._patch_pipeline.patch_pod if self._patch_pipeline is not None else None

    def _node_chip_topology(self, inventory: DeviceInventory):
        """This node's chip grid for gang placement: the same
        ``tpushare.aliyun.com/topology`` label rule the extender applies,
        so the allocator's gang decisions agree with the extender's grid.
        An unreachable apiserver or a missing label falls back to the
        default grid for the card count."""
        from ..topology import ChipTopology

        n_chips = len(inventory.units_by_index())
        node: dict = {}
        try:
            node = self._api.get_node(self._cfg.node_name)
        except Exception as e:  # noqa: BLE001 — degrade to the default grid
            log.v(4, "node topology label read failed (%s); using default", e)
        return ChipTopology.from_node(node, max(1, n_chips))

    def _build_core_allocate_fn(self, inventory: DeviceInventory, unhealthy_fn):
        """Whole-card allocator for the tpu-core resource.

        Unlike tpu-mem, core device IDs *are* the real card ids. Cluster
        mode validates them against fractional usage and existing holds
        and persists the decision (``ClusterCoreAllocator``); standalone
        mode accounts the hold in-process so mem binpack and core grants
        cannot double-book a card.
        """
        topo = self._backend.topology()
        if self._cluster:
            from ..allocator.cluster import ClusterCoreAllocator

            core = ClusterCoreAllocator(
                inventory,
                self._api,
                self._pod_source,
                self._cfg.node_name,
                topology=topo,
                unhealthy_chips_fn=unhealthy_fn,
                assume=self._alloc_assume,
                checkpoint=self._ckpt,
                patcher=self._patcher(),
            )
            return core.allocate
        local = self._local

        def allocate(granted: Sequence[Sequence[str]]):
            # One atomic hold for the whole pod: hold_chips validates
            # every card before recording any, so a conflict on one
            # container cannot leak the others' holds.
            all_indices = [inventory.index_of(cid) for ids in granted for cid in ids]
            if local is not None:
                local.hold_chips(all_indices)  # raises on conflict
            return [
                build_core_allocation(
                    chips=[inventory.chip_by_id(cid) for cid in ids],
                    process_bounds=topo.process_bounds,
                    chips_per_process_bounds=topo.chips_per_process_bounds,
                )
                for ids in granted
            ]

        return allocate

    def _local_sink(self, inventory: DeviceInventory):
        """Health sink feeding the standalone allocator: an Unhealthy card
        leaves binpack and refuses core holds until it recovers."""
        local = self._local

        def sink(chip_id: str | None, health: ChipHealth) -> None:
            ok = health == ChipHealth.HEALTHY
            ids = [c.id for c in inventory.chips()] if chip_id is None else [chip_id]
            for cid in ids:
                local.set_chip_health(inventory.index_of(cid), ok)

        return sink

    def _build_plugins(self, inventory: DeviceInventory) -> list:
        from ..allocator.cluster import preferred_core_chips
        from ..plugin.server import PluginConfig, TpuSharePlugin

        plugins = []
        mem_plugin = TpuSharePlugin(
            inventory,
            allocate_fn=None,  # late-bound: the allocator may read this
            # plugin's live health view
            config=PluginConfig(
                resource_name=const.RESOURCE_MEM,
                socket_name=const.MEM_SOCKET_NAME,
                plugin_dir=self._cfg.plugin_dir,
            ),
        )
        mem_plugin.set_allocate_fn(
            self._build_allocator(inventory, unhealthy_fn=mem_plugin.unhealthy_chip_indices)
        )
        plugins.append(mem_plugin)
        if self._cfg.serve_core_resource:
            if self._cluster:
                from ..allocator.cluster import cluster_chip_state

                state_fn = cluster_chip_state(self._pod_source, assume=self._alloc_assume)
            else:
                local = self._local

                def state_fn():
                    if local is None:
                        return {}, set()
                    return local.used_by_chip(), local.core_held()

            core_plugin = TpuSharePlugin(
                inventory,
                allocate_fn=None,
                config=PluginConfig(
                    resource_name=const.RESOURCE_CORE,
                    socket_name=const.CORE_SOCKET_NAME,
                    plugin_dir=self._cfg.plugin_dir,
                ),
                devices_fn=inventory.core_devices,
                preferred_fn=preferred_core_chips(inventory, state_fn),
            )
            core_plugin.set_allocate_fn(
                self._build_core_allocate_fn(
                    inventory, unhealthy_fn=core_plugin.unhealthy_chip_indices
                )
            )
            plugins.append(core_plugin)
        return plugins

    # ------------------------------------------------------------------

    def _serve_all(self) -> None:
        inventory = self._build_inventory()
        if inventory is None:
            raise RuntimeError("no cards found at rebuild")
        if self._cluster and self._cfg.node_name:
            self._patch_node(inventory)
        # Crash recovery BEFORE the plugins serve: claim the fencing
        # generation (a stale duplicate instance observes it and refuses)
        # and replay unresolved journal entries into the ledger, so the
        # first Allocate after a restart already sees every in-flight
        # reservation the previous incarnation died holding.
        if self._ckpt is not None:
            if self._cfg.node_name:
                try:
                    self._ckpt.acquire_fence(self._api, self._cfg.node_name)
                except Exception as e:
                    log.warning("fence acquire failed (%s); continuing unfenced", e)
            n = replay_checkpoint(self._ckpt, self._alloc_assume)
            if n:
                log.info(
                    "device-state replay: %d in-flight allocation(s) "
                    "restored from checkpoint", n,
                )
        self._plugins = self._build_plugins(inventory)
        for plugin in self._plugins:
            plugin.serve()
        if self._cfg.health_check:
            sinks = [p.set_chip_health for p in self._plugins]
            if self._local is not None:
                sinks.append(self._local_sink(inventory))
            on_event = None
            if self._cluster and self._cfg.node_name:
                on_event = self._node_event_hook()
            self._health = HealthWatcher(self._backend, sinks=sinks, on_event=on_event)
            self._health.start()
        # The drift reconciler runs for the lifetime of this build; its
        # first pass resolves whatever the replay above re-reserved.
        if (
            self._cluster
            and self._pod_source is not None
            and self._cfg.reconcile_interval_s > 0
        ):
            from ..cluster.reconciler import DriftReconciler

            self._reconciler = DriftReconciler(
                api=self._api,
                pod_source=self._pod_source,
                assume=self._alloc_assume,
                checkpoint=self._ckpt,
                node_name=self._cfg.node_name,
                inventory=inventory,
                interval_s=self._cfg.reconcile_interval_s,
                move_restore_fn=self._move_restore_dispatch,
            ).start()
        if self._cluster and self._pod_source is not None:
            self._start_loops(inventory)

    def _start_loops(self, inventory: DeviceInventory) -> None:
        """The node's loops for this build, each where its interval is
        positive: live defragmentation and the interference detector (both
        need the node's name) and the timeline sampler."""
        name = self._cfg.node_name
        if self._cfg.defrag_interval_s > 0 and name:
            self._defrag = self._build_defrag_loop(inventory).start()
        if self._cfg.interference_interval_s > 0 and name:
            from ..cluster.interference import InterferenceDetector, InterferenceLoop

            self._interference = InterferenceLoop(
                InterferenceDetector(threshold=self._cfg.interference_threshold),
                self._api,
                name,
                self._pod_source,
                interval_s=self._cfg.interference_interval_s,
                scrape_urls=self._cfg.interference_scrape_urls,
            ).start()
        if self._cfg.timeline_interval_s > 0:
            self._timeline_loop = self._build_timeline_loop(inventory).start()

    def _build_defrag_loop(self, inventory: DeviceInventory):
        """Planner over the pod source, mover through the shared ledger, the
        WAL and the patch pipeline. Its first pass runs one full interval
        in, so the reconciler's first pass resolves any move the previous
        incarnation died holding before this one plans new work. Cards the
        mem plugin reads unhealthy are neither drained nor filled, as the
        admission allocator refuses to place on them."""
        from ..allocator.defrag import DefragLoop, DefragPlanner, SliceMover

        unhealthy_fns = [
            p.unhealthy_chip_indices
            for p in self._plugins
            if p.resource_name == const.RESOURCE_MEM
        ]

        def excluded() -> set[int]:
            return {i for fn in unhealthy_fns for i in fn()}

        planner = DefragPlanner(
            inventory.units_by_index,
            self._pod_source,
            quantum=self._cfg.defrag_quantum,
            excluded_fn=excluded,
            max_moves=self._cfg.defrag_max_moves,
            node=self._cfg.node_name,
        )
        mover = SliceMover(
            self._api,
            self._pod_source,
            self._alloc_assume,
            self._ckpt,
            self._cfg.node_name,
            inventory.units_by_index,
            drain_fn=self._move_drain_dispatch,
            restore_fn=self._move_restore_dispatch,
            patch_fn=self._patcher(),
        )
        return DefragLoop(
            planner, mover, self._api, self._cfg.node_name,
            interval_s=self._cfg.defrag_interval_s,
        )

    def _build_timeline_loop(self, inventory: DeviceInventory):
        """Fold utilization, fragmentation, queue depth and SLO burn into
        the timeline ring every tick: read-only sources, each best-effort."""
        from ..allocator.defrag import STRANDED_PCT_GAUGE
        from ..cluster import pods as PODS
        from ..utils.metrics import REGISTRY
        from ..utils.timeline import TIMELINE, TimelineLoop

        total_units = sum(inventory.units_by_index().values())
        pod_source = self._pod_source

        def util_pct():
            if not total_units:
                return None
            mem_used, _held = pod_source.chip_state()
            return 100.0 * sum(mem_used.values()) / total_units

        def queue_depth():
            # one pending-pod read feeds both series (a second LIST a tick
            # would double the read load on list-backed sources, from two
            # different snapshots)
            pending = pod_source.pending_share_pods(const.RESOURCE_MEM)
            return {
                "pending_pods": float(len(pending)),
                "pending_gangs": float(sum(1 for p in pending if PODS.gang_shape_request(p))),
            }

        def stranded_pct():
            return REGISTRY.gauge_value(STRANDED_PCT_GAUGE)

        def slo_burn_5m():
            series = REGISTRY.gauge_series(SLO_BURN_RATE)
            vals = [v for labels, v in series.items() if dict(labels).get("window") == "5m"]
            return max(vals) if vals else None

        return TimelineLoop(
            TIMELINE,
            {
                "util_pct": util_pct,
                "queue_depth": queue_depth,
                "stranded_pct": stranded_pct,
                "slo_burn_5m": slo_burn_5m,
            },
            interval_s=self._cfg.timeline_interval_s,
        )

    def _patch_node(self, inventory: DeviceInventory) -> None:
        """Advertise the card count on the node's status and re-read the
        isolation label, at every (re)build (upstream: podmanager.go:59-99
        read at server.go:60-74)."""
        from ..cluster.node import isolation_disabled, patch_chip_count

        try:
            patch_chip_count(self._api, self._cfg.node_name, inventory.chip_count)
        except Exception as e:
            log.warning("node capacity patch failed: %s", e)
        self._disable_isolation = self._cfg.disable_isolation or isolation_disabled(
            self._api, self._cfg.node_name
        )
        if self._disable_isolation:
            log.info("memory isolation disabled (config flag or node label)")

    def _node_event_hook(self):
        """The health watcher's ``on_event`` in cluster mode: each event
        becomes a node Event, posted by one worker with a bounded queue
        (an unreachable apiserver must neither stall health propagation
        nor grow a thread per poll tick; overflow drops are counted). Soft
        events are rate-limited per (card, reason): a ticking correctable
        error counter must not write an Event every poll. Hard transitions
        are rare (edge-triggered in the backend) and always pass."""
        from ..cluster.events import (
            REASON_CHIP_APP_FAULT,
            REASON_CHIP_RECOVERED,
            REASON_CHIP_TRANSIENT,
            REASON_CHIP_UNHEALTHY,
            NodeEventEmitter,
        )

        self._events = NodeEventEmitter(self._api, self._cfg.node_name).start()
        emitter = self._events
        last_emit: dict[tuple, float] = {}
        min_interval_s = 300.0

        def on_event(event) -> None:
            if event.severity == "app":
                reason, etype = REASON_CHIP_APP_FAULT, "Warning"
            elif event.severity == "transient":
                reason, etype = REASON_CHIP_TRANSIENT, "Normal"
            elif event.health == ChipHealth.UNHEALTHY:
                reason, etype = REASON_CHIP_UNHEALTHY, "Warning"
            else:
                reason, etype = REASON_CHIP_RECOVERED, "Normal"
            if event.severity != "hard":
                key = (event.chip_id, reason)
                now = time.monotonic()
                if now - last_emit.get(key, -min_interval_s) < min_interval_s:
                    return
                last_emit[key] = now
            emitter.emit(
                reason,
                f"chip {event.chip_id or 'ALL'}: {event.reason}",
                event_type=etype,
            )

        return on_event

    def _stop_all(self) -> None:
        if self._timeline_loop is not None:
            self._timeline_loop.stop()
            self._timeline_loop = None
        if self._interference is not None:
            self._interference.stop()
            self._interference = None
        if self._defrag is not None:
            # before the reconciler: a move stopped mid-shutdown must not
            # lose its resolver while it still journals phases
            self._defrag.stop()
            self._defrag = None
        if self._reconciler is not None:
            self._reconciler.stop()
            self._reconciler = None
        if self._health is not None:
            self._health.stop()
            self._health = None
        if self._events is not None:
            self._events.stop()
            self._events = None
        # Graceful drain first: refuse new Allocate RPCs on EVERY plugin
        # at once (quiesce), then wait for in-flight ones against one
        # shared deadline: the total drain must fit one grace budget, not N.
        for plugin in self._plugins:
            try:
                plugin.quiesce()
            except Exception as e:
                log.warning("plugin quiesce failed: %s", e)
        deadline = time.monotonic() + self._cfg.drain_timeout_s
        for plugin in self._plugins:
            try:
                remaining = max(0.0, deadline - time.monotonic())
                if not plugin.drain(remaining):
                    log.warning(
                        "plugin %s did not drain within %.1fs; stopping anyway",
                        plugin.resource_name, self._cfg.drain_timeout_s,
                    )
            except Exception as e:
                log.warning("plugin drain failed: %s", e)
        for plugin in self._plugins:
            try:
                plugin.stop()
            except Exception as e:
                log.warning("plugin stop failed: %s", e)
        self._plugins = []
        if self._ckpt is not None:
            self._ckpt.flush()

    # ------------------------------------------------------------------

    def _install_flight_recorder(self) -> None:
        """From here on a fatal exit or an injected crash leaves a
        postmortem (traces and recent logs) on disk."""
        if self._cfg.flightrecord_dir:
            from ..utils.flightrec import FLIGHT

            FLIGHT.install(self._cfg.flightrecord_dir, max_dumps=self._cfg.flightrecord_keep)

    def install_signal_handlers(self) -> None:
        signal.signal(signal.SIGHUP, lambda *_: self.trigger_restart("SIGHUP"))
        signal.signal(signal.SIGINT, lambda *_: self.trigger_stop("SIGINT"))
        signal.signal(signal.SIGTERM, lambda *_: self.trigger_stop("SIGTERM"))
        try:
            signal.signal(
                signal.SIGQUIT,
                lambda *_: log.info("stack dump: %s", coredump(self._cfg.coredump_dir)),
            )
        except (OSError, ValueError):
            pass
        # SIGUSR1: live postmortem, the flight recorder's dump (last N
        # traces and the recent log ring) without disturbing the daemon,
        # the trace analog of SIGQUIT's stack dump.
        if self._cfg.flightrecord_dir:
            from ..utils.flightrec import FLIGHT

            FLIGHT.install_signal_handler()

    def trigger_restart(self, reason: str = "") -> None:
        log.info("restart requested (%s)", reason or "socket watcher")
        self._restart.set()
        self._park.set()

    def trigger_stop(self, reason: str = "") -> None:
        log.info("stop requested (%s)", reason)
        self._stop.set()
        self._restart.set()
        self._park.set()

    def run(self) -> None:
        """Blocking main loop; returns only on stop."""
        self._install_flight_recorder()
        if self._build_inventory() is None:
            # No cards here: park forever instead of crash-looping, so the
            # DaemonSet stays green on heterogeneous fleets
            # (gpumanager.go:36-47 semantics).
            log.info("no cards found on this node; parking")
            self._parked = True
            self._park.wait()
            return
        # Restart detection across the whole device-plugin dir: kubelet.sock
        # recreation (kubelet restart) or our own plugin sockets vanishing
        # (kubelet cleanup that silently unregisters us). Suspended around
        # our own rebuilds so self-inflicted socket churn never loops.
        watcher = PluginDirWatcher(
            kubelet_sock_path=f"{self._cfg.plugin_dir.rstrip('/')}/kubelet.sock",
            plugin_sockets_fn=lambda: [p.socket_path for p in self._plugins],
        )
        watcher.start(on_recreate=lambda reason: self.trigger_restart(reason))
        try:
            while not self._stop.is_set():
                self._restart.clear()
                watcher.suspend()
                try:
                    self._serve_all()
                except Exception as e:
                    log.error("serve failed: %s; retrying in 5s", e)
                    self._stop_all()
                    if self._stop.wait(5.0):
                        break
                    continue
                watcher.resume()
                self._restart.wait()
                watcher.suspend()
                self._stop_all()
        finally:
            watcher.stop()
            self._stop_all()
            if self._patch_pipeline is not None:
                # after the drain: in-flight admissions have finished their
                # PATCHes, so stopping the dispatcher strands nothing
                self._patch_pipeline.stop()
            if self._ckpt is not None:
                # graceful shutdown: the journal is flushed and closed so
                # the next incarnation loads a clean file
                self._ckpt.close()
