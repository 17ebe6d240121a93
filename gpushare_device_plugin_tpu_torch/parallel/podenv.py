"""Read the device plugin's injected env inside a workload pod.

Counterpart of ``gpushare_device_plugin_tpu/parallel/podenv.py``. The
plugin's Allocate() injects:

- ``TPU_VISIBLE_CHIPS``: comma-separated local chip indices granted to the
  container (the analog of ``NVIDIA_VISIBLE_DEVICES``);
- ``TPU_PROCESS_BOUNDS`` / ``TPU_CHIPS_PER_PROCESS_BOUNDS``: multi-host
  slice topology strings;
- ``ALIYUN_COM_TPU_MEM_{IDX,POD,CONTAINER,DEV}``: the memory-unit
  accounting, and the gang grant ``ALIYUN_COM_TPU_GANG_*``;
- ``TPU_HBM_LIMIT_FRACTION``: the cooperative memory cap;
- ``ALIYUN_COM_TPU_WORKLOAD_CLASS`` and ``ALIYUN_COM_TPU_LORA_ADAPTER``.

:class:`PodTpuEnv` parses all of it into the reference's record, field
for field. :func:`configure_torch_from_env` is the twin of the reference's
``configure_jax_from_env``: it maps the granted chips to
``CUDA_VISIBLE_DEVICES`` and caps the process's device memory at its
fraction. The process and chip bounds are parsed but have no CUDA
counterpart, so nothing reads them here.

The mesh half: :func:`gang_mesh_spec` / :func:`gang_mesh` give a gang
grant's mesh, and :func:`initialize_multihost` joins this process to its
pod group's ``torch.distributed`` world from the ``TPUSHARE_*`` env
(:func:`multihost_spec`), where the reference calls
``jax.distributed.initialize``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Mapping

import torch
import torch.distributed as dist

from .. import const
from .mesh import Mesh, MeshSpec, make_mesh
from .topology import parse_shape

# The key of the memory cap in configure_torch_from_env's settings: the
# argument of torch.cuda.set_per_process_memory_fraction, not an env var.
MEMORY_FRACTION = "memory_fraction"


def _env_int(e: Mapping[str, str], key: str, default: int) -> int:
    try:
        return int(e.get(key, ""))
    except ValueError:
        return default


def _env_str(e: Mapping[str, str], key: str, default: str = "") -> str:
    """Absent, None-ish and whitespace-only all read as ``default``;
    anything else is stripped."""
    val = str(e.get(key, "") or "").strip()
    return val if val else default


def _env_choice(
    e: Mapping[str, str], key: str, choices: tuple[str, ...], default: str
) -> str:
    """:func:`_env_str` held to an enumerated value; anything off the list
    reads as ``default``."""
    val = _env_str(e, key)
    return val if val in choices else default


@dataclasses.dataclass(frozen=True)
class PodTpuEnv:
    """Parsed view of the plugin-injected container env."""

    visible_chips: tuple[int, ...]  # local chip indices granted
    chip_index: int  # primary assigned chip (MEM_IDX), -1 if unset
    mem_units_container: int  # this container's memory units
    mem_units_chip: int  # total units on the assigned chip
    process_bounds: str  # "" on a single host
    chips_per_process_bounds: str
    hbm_fraction: float  # cooperative cap in (0, 1]
    # Multi-chip gang grant: the member chips, the granted shape and the
    # units claimed on EACH member. Empty/0 for single-chip pods.
    gang_chips: tuple[int, ...] = ()
    gang_shape: tuple[int, ...] = ()
    gang_per_chip: int = 0
    mem_units_pod: int = 0  # the whole pod's units (MEM_POD), 0 unset
    # QoS class: latency-critical | best-effort. A serving engine's step
    # governor reads it.
    workload_class: str = const.WORKLOAD_LATENCY_CRITICAL
    # The tenant's LoRA adapter id; "" = the base model.
    lora_adapter: str = ""

    @property
    def is_best_effort(self) -> bool:
        return self.workload_class == const.WORKLOAD_BEST_EFFORT

    @property
    def exclusive(self) -> bool:
        """Whole chip(s) granted: no memory cap needed."""
        return self.hbm_fraction >= 0.999

    @property
    def is_gang(self) -> bool:
        return len(self.gang_chips) > 1

    def mem_bytes(self, unit: const.MemoryUnit | None = None) -> int:
        """This container's slice in bytes (GiB units unless the cluster
        runs ``--memory-unit=MiB``). For a gang it is the total across the
        member chips; the per-chip share is :meth:`gang_per_chip_bytes`."""
        u = unit if unit is not None else const.MemoryUnit.GiB
        return self.mem_units_container * u.num_bytes

    def gang_per_chip_bytes(self, unit: const.MemoryUnit | None = None) -> int:
        """The slice this gang holds on each member chip, in bytes (0 for a
        pod that is not a gang); the whole pod's share."""
        u = unit if unit is not None else const.MemoryUnit.GiB
        return self.gang_per_chip * u.num_bytes

    def gang_container_per_chip_bytes(self, unit: const.MemoryUnit | None = None) -> int:
        """This container's part of the per-chip share: the pod's share
        scaled by the container's fraction of the pod's units, so two
        containers of one gang pod do not each size to the whole share."""
        per = self.gang_per_chip_bytes(unit)
        if 0 < self.mem_units_container < self.mem_units_pod:
            return per * self.mem_units_container // self.mem_units_pod
        return per

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "PodTpuEnv":
        e = os.environ if env is None else env

        def _int_list(key: str) -> tuple[int, ...]:
            raw = e.get(key, "")
            return tuple(int(tok) for tok in raw.split(",") if tok.strip().isdigit())

        container_units = _env_int(e, const.ENV_MEM_CONTAINER, 0)
        chip_units = _env_int(e, const.ENV_MEM_DEV, 0)
        gang_chips = _int_list(const.ENV_GANG_CHIPS)
        gang_per_chip = _env_int(e, const.ENV_GANG_PER_CHIP, 0)
        gang_shape: tuple[int, ...] = ()
        shape_raw = _env_str(e, const.ENV_GANG_SHAPE)
        if shape_raw:
            try:
                gang_shape = parse_shape(shape_raw)
            except ValueError:
                gang_shape = ()
        explicit = None
        frac_raw = e.get(const.ENV_XLA_MEM_FRACTION, "")
        if frac_raw:
            try:
                explicit = min(1.0, max(0.0, float(frac_raw)))
            except ValueError:
                explicit = None
        if gang_chips and gang_per_chip > 0 and chip_units > 0:
            # A gang caps per chip: each member holds gang_per_chip units.
            derived = min(1.0, gang_per_chip / chip_units)
            fraction = min(explicit, derived) if explicit is not None else derived
        elif container_units > 0 and chip_units > 0:
            # The container never gets more than its own units' fraction,
            # whatever the explicit env says.
            derived = min(1.0, container_units / chip_units)
            fraction = min(explicit, derived) if explicit is not None else derived
        else:
            fraction = explicit if explicit is not None else 1.0
        return cls(
            visible_chips=_int_list(const.ENV_TPU_VISIBLE_CHIPS),
            chip_index=_env_int(e, const.ENV_MEM_IDX, -1),
            mem_units_container=container_units,
            mem_units_chip=chip_units,
            process_bounds=_env_str(e, const.ENV_TPU_PROCESS_BOUNDS),
            chips_per_process_bounds=_env_str(e, const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS),
            hbm_fraction=fraction,
            gang_chips=gang_chips,
            gang_shape=gang_shape,
            gang_per_chip=gang_per_chip,
            mem_units_pod=_env_int(e, const.ENV_MEM_POD, 0),
            workload_class=_env_choice(
                e, const.ENV_WORKLOAD_CLASS, const.WORKLOAD_CLASSES,
                const.WORKLOAD_LATENCY_CRITICAL,
            ),
            lora_adapter=_env_str(e, const.ENV_LORA_ADAPTER),
        )


def configure_torch_from_env(
    env: Mapping[str, str] | None = None,
    *,
    headroom: float = 0.95,
) -> dict[str, str]:
    """The PyTorch settings for this pod, from the injected env.

    Returns ``CUDA_VISIBLE_DEVICES`` (the granted chips) with
    ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` beside it (CUDA numbers cards fastest
    first otherwise, while the plugin's index is NVML's, by PCI bus id, so
    only that order makes the granted index name the same card in the
    pod) and, unless the pod holds whole chips, :data:`MEMORY_FRACTION`:
    ``hbm_fraction · headroom`` as ``"%.3f"``, the value the reference gives
    ``XLA_PYTHON_CLIENT_MEM_FRACTION``. ``headroom`` shaves the cap so
    two co-scheduled pods whose fractions sum to 1 do not collide on
    allocator slack.

    With a mapping the call is pure. With ``env=None`` (in the pod) it
    also applies them, and must run before anything initializes CUDA: it
    sets ``CUDA_DEVICE_ORDER`` and ``CUDA_VISIBLE_DEVICES``, then caps each
    visible device with
    ``torch.cuda.set_per_process_memory_fraction``. The cap covers what
    PyTorch's caching allocator reserves, cuBLAS and cuDNN workspaces
    included, but not the CUDA context itself. A pod that goes past it
    gets ``torch.cuda.OutOfMemoryError`` in its own process, not in its
    neighbour's. Sharing is cooperative: nothing in the card enforces it.

    Raises ``RuntimeError`` when CUDA is already initialized under another
    visible set, or when a capped pod finds no CUDA: it never carries on
    uncapped.
    """
    pod = PodTpuEnv.from_env(env)
    settings: dict[str, str] = {}
    if pod.visible_chips:
        settings[const.ENV_CUDA_DEVICE_ORDER] = const.CUDA_DEVICE_ORDER_PCI
        settings[const.ENV_CUDA_VISIBLE_DEVICES] = ",".join(str(i) for i in pod.visible_chips)
    if not pod.exclusive:
        settings[MEMORY_FRACTION] = f"{pod.hbm_fraction * headroom:.3f}"
    if env is not None:
        return settings

    visible = settings.get(const.ENV_CUDA_VISIBLE_DEVICES)
    if visible is not None:
        current = os.environ.get(const.ENV_CUDA_VISIBLE_DEVICES)
        if torch.cuda.is_initialized() and current != visible:
            raise RuntimeError(
                f"CUDA was initialized with {const.ENV_CUDA_VISIBLE_DEVICES}={current!r} "
                f"before the pod's grant {visible!r} could apply: call "
                "configure_torch_from_env() before any CUDA use"
            )
        os.environ[const.ENV_CUDA_DEVICE_ORDER] = settings[const.ENV_CUDA_DEVICE_ORDER]
        os.environ[const.ENV_CUDA_VISIBLE_DEVICES] = visible
    if MEMORY_FRACTION in settings:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"the pod is capped at {settings[MEMORY_FRACTION]} of its chip, but "
                "CUDA is not available: refusing to run uncapped"
            )
        for device in range(torch.cuda.device_count()):
            torch.cuda.set_per_process_memory_fraction(float(settings[MEMORY_FRACTION]), device)
    return settings


def gang_mesh_spec(pod: PodTpuEnv | None = None,
                   env: Mapping[str, str] | None = None) -> MeshSpec | None:
    """The mesh a granted gang forms: tensor parallelism over its member
    chips (``MeshSpec(tp=n)``), the serving default. Training that wants
    dp or fsdp factors the same count through ``MeshSpec.auto``. None for a
    pod that is not a gang."""
    p = pod if pod is not None else PodTpuEnv.from_env(env)
    if not p.is_gang:
        return None
    return MeshSpec(tp=len(p.gang_chips))


def gang_mesh(pod: PodTpuEnv | None = None, env: Mapping[str, str] | None = None, *,
              device: str | torch.device | None = None,
              backend: str | None = None) -> Mesh | None:
    """The gang's mesh over the ranks of the ``torch.distributed`` world
    (one rank per granted chip; :func:`.mesh.make_mesh`'s ``device`` and
    ``backend``). None for a pod that is not a gang. Raises when the world
    size is not the gang size: either way the env was mis-injected, and
    meshing over the ranks there are would shard onto chips this pod was
    never granted, or leave granted chips idle."""
    p = pod if pod is not None else PodTpuEnv.from_env(env)
    spec = gang_mesh_spec(p)
    if spec is None:
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != spec.size:
        raise ValueError(
            f"gang grant spans {spec.size} chips but the process group has {world} "
            "ranks: TPU_VISIBLE_CHIPS, the gang annotations and the multi-host env disagree"
        )
    return make_mesh(spec, device=device, backend=backend)


@dataclasses.dataclass(frozen=True)
class MultihostSpec:
    """Parsed multi-host bootstrap env (one pod per host)."""

    coordinator_address: str
    num_processes: int
    process_id: int

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1 and bool(self.coordinator_address)


def _ordinal_from_hostname(hostname: str) -> int | None:
    """StatefulSet pods are named ``<name>-<ordinal>``: a stable process id."""
    _, _, tail = hostname.rpartition("-")
    return int(tail) if tail.isdigit() else None


def multihost_spec(env: Mapping[str, str] | None = None) -> MultihostSpec:
    """The multi-host bootstrap contract from the container env.

    ``TPUSHARE_PROCESS_ID`` defaults to the StatefulSet ordinal in the
    hostname. A multi-host spec with no process id to be found, or one out
    of range, raises rather than let every pod claim process 0 (which
    would hang the rendezvous).
    """
    e = os.environ if env is None else env
    coordinator = e.get(const.ENV_COORDINATOR_ADDRESS, "")
    num = _env_int(e, const.ENV_NUM_PROCESSES, 1)
    pid = _env_int(e, const.ENV_PROCESS_ID, -1)
    if pid < 0:
        ordinal = _ordinal_from_hostname(e.get("HOSTNAME", ""))
        if ordinal is None:
            if num > 1 and coordinator:
                raise ValueError(
                    f"multi-host spec ({const.ENV_NUM_PROCESSES}={num}) but "
                    f"no {const.ENV_PROCESS_ID} and hostname "
                    f"{e.get('HOSTNAME', '')!r} has no StatefulSet ordinal "
                    "suffix — cannot determine this pod's process id"
                )
            ordinal = 0
        pid = ordinal
    if num > 1 and coordinator and pid >= num:
        raise ValueError(
            f"process id {pid} out of range for {const.ENV_NUM_PROCESSES}={num} "
            "(pod name ordinal and the StatefulSet replica count disagree?)"
        )
    return MultihostSpec(coordinator_address=coordinator, num_processes=num, process_id=pid)


def initialize_multihost(env: Mapping[str, str] | None = None, *, backend: str,
                         timeout_s: float = 60.0) -> MultihostSpec:
    """Join this process to its pod group's ``torch.distributed`` world
    from the injected env: ``init_process_group(backend,
    init_method="tcp://<coordinator>", world_size=num_processes,
    rank=process_id)``, waiting at most ``timeout_s`` for the rendezvous
    and for any collective after it. A no-op on a single host. Call once,
    after :func:`configure_torch_from_env`; then :func:`.mesh.make_mesh`
    builds the mesh over the world. ``backend`` is the caller's choice
    (``"nccl"`` across cards, ``"gloo"`` for CPU ranks or ranks that share
    a card)."""
    spec = multihost_spec(env)
    if spec.is_multihost:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{spec.coordinator_address}",
            world_size=spec.num_processes, rank=spec.process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    return spec
