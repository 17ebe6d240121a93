"""Daemon lifecycle manager, standalone mode.

Counterpart of ``gpushare_device_plugin_tpu/manager/lifecycle.py``, cut
to standalone mode (upstream: ``sharedGPUManager.Run``,
``gpumanager.go:33-108``):

- park forever (never crash-loop) on nodes without cards,
- serve the device plugins (``tpu-mem`` fan-out and whole-card
  ``tpu-core``), accounted in-process by one ``LocalAllocator``,
- feed the health watcher into both plugins and the allocator, so binpack
  and core holds route around sick cards,
- rebuild and re-register when kubelet restarts (plugin-dir watcher) or
  on SIGHUP,
- SIGQUIT dumps all-thread stacks to a file, SIGUSR1 a flight record,
- SIGTERM/SIGINT quiesce every plugin, drain in-flight Allocate calls
  against one deadline, then stop.

Cluster mode (``standalone=False``, an apiserver client or a pod source:
the WAL checkpoint and its replay, the drift reconciler, live
defragmentation and its move hooks, the interference loop, the timeline
sampler and node events) is not ported yet and raises
``NotImplementedError``.

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
from ..allocator.env import build_core_allocation
from ..allocator.local import LocalAllocator
from ..device.fanout import DeviceInventory
from ..discovery.base import ChipHealth, DiscoveryBackend
from ..utils.faults import FAULTS
from ..utils.log import get_logger
from ..utils.stacktrace import coredump
from .health import HealthWatcher
from .watchers import PluginDirWatcher

log = get_logger("manager")


def _cluster_mode(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is cluster mode, which the port does not have yet: "
        "run the manager standalone (ManagerConfig(standalone=True), "
        "the daemon's --standalone)"
    )


@dataclasses.dataclass
class ManagerConfig:
    plugin_dir: str = const.DEVICE_PLUGIN_PATH
    memory_unit: const.MemoryUnit = const.MemoryUnit.GiB
    policy: str = "first-fit"
    health_check: bool = False
    # No apiserver: LocalAllocator accounting. Without the apiserver there
    # is no pod-lifecycle feed, so allocations are never reclaimed until
    # the daemon restarts (a rebuild starts a fresh allocator). False is
    # cluster mode, which the port does not have yet.
    standalone: bool = False
    serve_core_resource: bool = True
    disable_isolation: bool = False
    coredump_dir: str = "/etc/kubernetes"
    # How long graceful shutdown waits for in-flight Allocate calls.
    drain_timeout_s: float = 5.0
    # Flight-recorder dump directory (utils/flightrec.py): SIGUSR1, fatal
    # exit and injected-crash postmortems land here. Empty disables (the
    # daemon defaults it to the coredump dir). flightrecord_keep bounds
    # the directory to the newest K dump files (0 = unbounded).
    flightrecord_dir: str = ""
    flightrecord_keep: int = 16
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
        if not config.standalone or api_client is not None or pod_source is not None:
            raise _cluster_mode(
                "a manager with an apiserver (the WAL checkpoint, the "
                "reconciler, defragmentation, interference, the timeline "
                "loop and node events)"
            )
        self._backend = backend
        self._cfg = config
        self._plugins: list = []  # plugin.server.TpuSharePlugin, built in _serve_all
        self._health: HealthWatcher | None = None
        self._local: LocalAllocator | None = None
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
        raise _cluster_mode("live defragmentation (set_move_hooks)")

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
        """The mem plugin's allocate function. Standalone accounting in
        one ``LocalAllocator``, whose health view the watcher feeds
        through :meth:`_local_sink` (``unhealthy_fn``, the plugin's view,
        is what cluster mode reads)."""
        log.warning(
            "standalone mode: allocations are accounted in-process and "
            "never reclaimed on pod deletion (dev/bench only)"
        )
        self._local = LocalAllocator(
            inventory,
            policy=self._cfg.policy,
            disable_isolation=self._cfg.disable_isolation,
        )
        local = self._local
        return lambda granted: local.allocate([len(g) for g in granted])

    def _build_core_allocate_fn(self, inventory: DeviceInventory, unhealthy_fn):
        """Whole-card allocator for the tpu-core resource.

        Unlike tpu-mem, core device IDs *are* the real card ids. Standalone
        mode accounts the hold in-process so mem binpack and core grants
        cannot double-book a card.
        """
        topo = self._backend.topology()
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
        self._plugins = self._build_plugins(inventory)
        for plugin in self._plugins:
            plugin.serve()
        if self._cfg.health_check:
            sinks = [p.set_chip_health for p in self._plugins]
            if self._local is not None:
                sinks.append(self._local_sink(inventory))
            self._health = HealthWatcher(self._backend, sinks=sinks)
            self._health.start()

    def _stop_all(self) -> None:
        if self._health is not None:
            self._health.stop()
            self._health = None
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
