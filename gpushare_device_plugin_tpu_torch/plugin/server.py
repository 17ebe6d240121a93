"""Device-plugin gRPC server + kubelet registration.

Counterpart of ``gpushare_device_plugin_tpu/plugin/server.py``, copied:
upstream's ``server.go:89-245``. Serve the ``v1beta1.DevicePlugin`` RPCs
on a unix socket under the kubelet device-plugin dir, self-dial to
confirm liveness, then register the resource name with kubelet, which
calls back with ListAndWatch/Allocate.

Beyond upstream:
- ListAndWatch supports health *recovery* (upstream marks unhealthy as
  terminal, FIXME ``server.go:184``) and coalesces a burst of per-fake-device
  events into one re-send (upstream re-streams the full list once per
  fake device of a failed card, ``server.go:183-186``).
- Multiple concurrent ListAndWatch streams are supported (kubelet restarts
  mid-stream leave stale streams behind until their sends fail).
- Allocate counts its in-flight calls, so ``drain`` can wait for them,
  and ``quiesce`` refuses new ones at once (the daemon quiesces every
  plugin before it drains any).
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent import futures
from typing import Callable, Sequence

import grpc

from .. import const
from ..device.fanout import DeviceInventory, FakeDevice
from ..discovery.base import ChipHealth
from ..utils.lockrank import make_condition
from ..utils.log import get_logger
from ..utils.metric_catalog import ALLOCATE_SECONDS, ALLOCATE_TOTAL
from ..utils.tracing import TRACER
from .api import (
    DevicePluginServicer,
    DevicePluginStub,
    RegistrationStub,
    add_device_plugin_servicer,
    pb,
)

log = get_logger("plugin.server")

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


@dataclasses.dataclass
class PluginConfig:
    resource_name: str = const.RESOURCE_MEM
    socket_name: str = const.MEM_SOCKET_NAME
    plugin_dir: str = const.DEVICE_PLUGIN_PATH
    kubelet_socket: str = ""  # default: <plugin_dir>/kubelet.sock
    api_version: str = const.API_VERSION
    grpc_workers: int = 8
    pre_start_required: bool = False

    @property
    def socket_path(self) -> str:
        return os.path.join(self.plugin_dir, self.socket_name)

    @property
    def kubelet_socket_path(self) -> str:
        return self.kubelet_socket or os.path.join(self.plugin_dir, "kubelet.sock")


class TpuSharePlugin(DevicePluginServicer):
    """One plugin instance per resource name (tpu-mem, tpu-core)."""

    def __init__(
        self,
        inventory: DeviceInventory,
        allocate_fn: Callable[[Sequence[Sequence[str]]], list] | None,
        config: PluginConfig | None = None,
        devices_fn: Callable[..., list[FakeDevice]] | None = None,
        preferred_fn: Callable[[list[str], int], list[str]] | None = None,
    ):
        """``allocate_fn`` receives the per-container granted fake-ID lists
        and returns ``ContainerAllocation``s (see allocator.env); raising
        ``Exception`` maps to a gRPC error, which kubelet surfaces as an
        UnexpectedAdmissionError for the pod (``allocate.go:99-105``).

        ``devices_fn(health=...)`` overrides the advertised device list
        (default: the inventory's per-GiB fan-out). ``preferred_fn(available,
        size)`` orders GetPreferredAllocation picks (the core plugin steers
        kubelet away from cards with fractional usage).
        """
        self._inv = inventory
        self._allocate_fn = allocate_fn
        self._cfg = config or PluginConfig()
        self._devices_fn = devices_fn or inventory.mem_fake_devices
        self._preferred_fn = preferred_fn
        self._health: dict[str, ChipHealth] = {}
        self._cond = make_condition("plugin.stream")
        self._version = 0  # bumped on every health change
        self._stopping = False
        self._inflight_allocates = 0  # guarded by _cond; drain() waits on it
        self._server: grpc.Server | None = None
        self._registered = False

    @property
    def resource_name(self) -> str:
        return self._cfg.resource_name

    @property
    def socket_path(self) -> str:
        return self._cfg.socket_path

    # ------------------------------------------------------------------
    # health ingestion (fed by the manager's health watcher thread)
    # ------------------------------------------------------------------

    def set_allocate_fn(self, fn: Callable[[Sequence[Sequence[str]]], list]) -> None:
        """Late-bind the allocator (it may need this plugin's health view)."""
        self._allocate_fn = fn

    def set_chip_health(self, chip_id: str | None, health: ChipHealth) -> None:
        """Mark one chip (or all, when ``chip_id`` is None) and wake streams."""
        with self._cond:
            if chip_id is None:
                for chip in self._inv.chips():
                    self._health[chip.id] = health
            else:
                self._health[chip_id] = health
            self._version += 1
            self._cond.notify_all()

    def unhealthy_chip_indices(self) -> list[int]:
        with self._cond:
            known = {c.id for c in self._inv.chips()}
            return sorted(
                self._inv.index_of(cid)
                for cid, h in self._health.items()
                if h == ChipHealth.UNHEALTHY and cid in known
            )

    # ------------------------------------------------------------------
    # DevicePlugin RPCs
    # ------------------------------------------------------------------

    def GetDevicePluginOptions(self, request, context) -> pb.DevicePluginOptions:
        return pb.DevicePluginOptions(
            pre_start_required=self._cfg.pre_start_required,
            get_preferred_allocation_available=True,
        )

    def _snapshot(self) -> pb.ListAndWatchResponse:
        devices = self._devices_fn(health=dict(self._health))
        return pb.ListAndWatchResponse(
            devices=[
                pb.Device(ID=d.id, health=HEALTHY if d.healthy else UNHEALTHY)
                for d in devices
            ]
        )

    def ListAndWatch(self, request, context):
        """Stream the fake-device list; re-send on health transitions.

        Coalescing: we wait on a version counter, so N chip events between
        two sends produce one re-send of the full list.
        """
        with self._cond:
            sent_version = self._version
        snapshot = self._snapshot()
        yield snapshot
        log.v(
            1,
            "ListAndWatch: initial send of %d devices for %s",
            len(snapshot.devices),
            self._cfg.resource_name,
        )
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._version != sent_version or self._stopping,
                    timeout=1.0,
                )
                if self._stopping or not context.is_active():
                    return
                if self._version == sent_version:
                    continue
                sent_version = self._version
            yield self._snapshot()

    def GetPreferredAllocation(self, request, context) -> pb.PreferredAllocationResponse:
        # Fake memory-unit devices are fungible (which IDs kubelet grants
        # is irrelevant by design — Allocate only counts them), so the mem
        # plugin takes the first N. The core plugin injects a preferred_fn
        # that steers kubelet toward conflict-free cards.
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            cresp = resp.container_responses.add()
            available = list(creq.available_deviceIDs)
            if self._preferred_fn is not None:
                try:
                    picks = self._preferred_fn(available, creq.allocation_size)
                except Exception as e:  # noqa: BLE001 — preference only
                    log.warning("preferred_fn failed: %s", e)
                    picks = available[: creq.allocation_size]
            else:
                picks = available[: creq.allocation_size]
            cresp.deviceIDs.extend(picks)
        return resp

    def Allocate(self, request, context) -> pb.AllocateResponse:
        """Count granted fake IDs per container and delegate placement."""
        # In-flight accounting for graceful shutdown: a SIGTERM'd daemon
        # drains admissions that already started (their PATCH may be on
        # the wire — dying mid-write is the checkpoint's job to survive,
        # but not dying at all is better) and refuses new ones.
        with self._cond:
            if self._stopping:
                context.abort(
                    grpc.StatusCode.UNAVAILABLE, "plugin is shutting down"
                )
            self._inflight_allocates += 1
        try:
            return self._allocate_inner(request, context)
        finally:
            with self._cond:
                self._inflight_allocates -= 1
                self._cond.notify_all()

    def _allocate_inner(self, request, context) -> pb.AllocateResponse:
        from ..utils.faults import FAULTS
        from ..utils.metrics import REGISTRY

        try:
            FAULTS.fire("plugin.allocate")
        except Exception as e:  # injected kubelet-facing failure
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        granted = [list(creq.devicesIDs) for creq in request.container_requests]
        log.v(4, "Allocate: granted id counts %s", [len(g) for g in granted])
        if self._allocate_fn is None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, "allocator not bound")
        # The admission's plugin-process root span: the kubelet-facing
        # gRPC entry. The allocator's spans nest under it, and once the
        # pod is matched its trace-id annotation re-parents this whole
        # stack under the extender's bind span (one stitched trace). The
        # latency observation runs inside the span so the histogram
        # bucket carries this admission's trace id as an exemplar.
        with TRACER.span(
            "plugin.allocate",
            attributes={"resource": self._cfg.resource_name},
        ) as sp:
            sp.set_attribute("granted", [len(g) for g in granted])
            t0 = time.perf_counter()
            try:
                allocations = self._allocate_fn(granted)
            except Exception as e:  # business errors -> admission failure
                log.warning("Allocate failed: %s", e)
                REGISTRY.counter_inc(
                    ALLOCATE_TOTAL,
                    "Allocate RPCs by outcome",
                    resource=self._cfg.resource_name, outcome="error",
                )
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            REGISTRY.observe(
                ALLOCATE_SECONDS,
                time.perf_counter() - t0,
                "Allocate placement latency",
                resource=self._cfg.resource_name,
            )
            REGISTRY.counter_inc(
                ALLOCATE_TOTAL,
                "Allocate RPCs by outcome",
                resource=self._cfg.resource_name, outcome="ok",
            )
        resp = pb.AllocateResponse()
        for alloc in allocations:
            cresp = resp.container_responses.add()
            for k, v in alloc.envs.items():
                cresp.envs[k] = v
            for k, v in alloc.annotations.items():
                cresp.annotations[k] = v
            for dev in alloc.devices:
                cresp.devices.add(
                    container_path=dev.container_path,
                    host_path=dev.host_path,
                    permissions=dev.permissions,
                )
        return resp

    def PreStartContainer(self, request, context) -> pb.PreStartContainerResponse:
        # no-op (upstream: server.go:195-197)
        return pb.PreStartContainerResponse()

    # ------------------------------------------------------------------
    # lifecycle (upstream: server.go:110-245)
    # ------------------------------------------------------------------

    def start(self) -> None:
        """Listen on the plugin socket and confirm liveness by self-dialing."""
        path = self._cfg.socket_path
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(self._cfg.plugin_dir, exist_ok=True)
        self._stopping = False
        self._registered = False
        server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=self._cfg.grpc_workers,
                thread_name_prefix=f"plugin-{self._cfg.resource_name}",
            )
        )
        add_device_plugin_servicer(self, server)
        server.add_insecure_port(f"unix:{path}")
        server.start()
        self._server = server
        # self-dial sanity check (server.go:127-131)
        with grpc.insecure_channel(f"unix:{path}") as ch:
            grpc.channel_ready_future(ch).result(timeout=10)
            DevicePluginStub(ch).GetDevicePluginOptions(pb.Empty(), timeout=5)
        log.v(1, "plugin %s serving on %s", self._cfg.resource_name, path)

    def register(self, timeout: float = 10.0) -> None:
        """Announce this plugin to kubelet (``server.go:154-173``)."""
        with grpc.insecure_channel(f"unix:{self._cfg.kubelet_socket_path}") as ch:
            grpc.channel_ready_future(ch).result(timeout=timeout)
            RegistrationStub(ch).Register(
                pb.RegisterRequest(
                    version=self._cfg.api_version,
                    endpoint=self._cfg.socket_name,
                    resource_name=self._cfg.resource_name,
                    options=pb.DevicePluginOptions(
                        pre_start_required=self._cfg.pre_start_required,
                        get_preferred_allocation_available=True,
                    ),
                ),
                timeout=timeout,
            )
        self._registered = True
        log.v(1, "registered %s with kubelet", self._cfg.resource_name)

    @property
    def registered(self) -> bool:
        """True once this plugin announced itself to kubelet (the
        daemon's ``/readyz`` gate: an unregistered plugin serves no
        pods, whatever its socket says)."""
        return self._registered

    def serve(self) -> None:
        self.start()
        self.register()

    def quiesce(self) -> None:
        """Refuse new Allocate calls from now on, without waiting. The
        manager quiesces every plugin before draining any, so later
        plugins cannot keep admitting work while earlier ones drain."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Refuse new Allocate calls and wait for in-flight ones to finish
        (their apiserver PATCH completes and the journal entry resolves).
        True when the plugin drained inside the timeout; False means the
        caller proceeds to stop anyway — the checkpoint replay covers
        whatever was cut mid-write."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            return self._cond.wait_for(
                lambda: self._inflight_allocates == 0, timeout_s
            )

    def stop(self, grace: float = 1.0) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        path = self._cfg.socket_path
        if os.path.exists(path):
            try:
                os.unlink(path)
            except OSError:
                pass


def wait_for_socket(path: str, timeout: float = 10.0) -> bool:
    """Poll for a unix socket to appear (used by tests and the manager)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.02)
    return os.path.exists(path)
