"""Container payload: the env and devices a granted pod receives.

Counterpart of ``gpushare_device_plugin_tpu/allocator/env.py``, copied:
the env is the reference's key for key and value for value, because the
pod side (``parallel/podenv.py``) and the reference's control plane read
those names whatever the card. Upstream injects
``NVIDIA_VISIBLE_DEVICES=<idx>`` plus the ``ALIYUN_COM_GPU_MEM_*`` family
(``allocate.go:109-124``); here a pod gets

- ``TPU_VISIBLE_CHIPS``: which local card(s) the process may use
  (``configure_torch_from_env`` maps it to ``CUDA_VISIBLE_DEVICES``);
- ``TPU_PROCESS_BOUNDS`` / ``TPU_CHIPS_PER_PROCESS_BOUNDS``: the
  single-process topology carve-out;
- the ``ALIYUN_COM_TPU_MEM_*`` bookkeeping family (idx/pod/container/dev);
- a cooperative memory cap (``TPU_HBM_LIMIT_FRACTION``, and the same
  value as ``XLA_PYTHON_CLIENT_MEM_FRACTION``), because device memory has
  no hardware fence; disabled by ``disable_isolation`` (``CTPU_DISABLE``);

and an explicit ``DeviceSpec`` for the card's device file.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .. import const
from ..discovery.base import TpuChip
from ..parallel.topology import format_shape, pad3


@dataclasses.dataclass
class DeviceMount:
    container_path: str
    host_path: str
    permissions: str = "rw"


@dataclasses.dataclass
class ContainerAllocation:
    """One container's allocation payload (maps 1:1 onto the proto)."""

    envs: dict[str, str] = dataclasses.field(default_factory=dict)
    devices: list[DeviceMount] = dataclasses.field(default_factory=list)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)


def visible_chips_value(chip_indices: Sequence[int]) -> str:
    return ",".join(str(i) for i in sorted(chip_indices))


def build_mem_allocation(
    *,
    chip: TpuChip,
    chip_total_units: int,
    pod_units: int,
    container_units: int,
    disable_isolation: bool = False,
    workload_class: str = "",
    lora_adapter: str = "",
) -> ContainerAllocation:
    """Payload for a fractional-memory container pinned to one chip.

    ``workload_class`` (the pod's normalized QoS class) and
    ``lora_adapter`` (the pod's adapter id, empty for the base model) are
    mirrored into the env for the workload inside."""
    envs = {
        const.ENV_TPU_VISIBLE_CHIPS: str(chip.index),
        # one process, one chip
        const.ENV_TPU_PROCESS_BOUNDS: "1,1,1",
        const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS: "1,1,1",
        const.ENV_MEM_IDX: str(chip.index),
        const.ENV_MEM_POD: str(pod_units),
        const.ENV_MEM_CONTAINER: str(container_units),
        const.ENV_MEM_DEV: str(chip_total_units),
    }
    if workload_class:
        envs[const.ENV_WORKLOAD_CLASS] = workload_class
    if lora_adapter:
        envs[const.ENV_LORA_ADAPTER] = lora_adapter
    if disable_isolation:
        envs["CTPU_DISABLE"] = "true"
    elif chip_total_units > 0:
        # Per-container, not per-pod: each container is its own process;
        # capping every container at the pod's total fraction would let a
        # 2-container pod take double its entitlement.
        units = container_units if container_units > 0 else pod_units
        frac = min(1.0, units / chip_total_units)
        envs[const.ENV_XLA_MEM_FRACTION] = f"{frac:.4f}"
        envs[const.ENV_XLA_PYTHON_MEM_FRACTION] = f"{frac:.4f}"
    alloc = ContainerAllocation(envs=envs)
    if chip.device_path:
        alloc.devices.append(
            DeviceMount(container_path=chip.device_path, host_path=chip.device_path)
        )
    return alloc


def build_core_allocation(
    *, chips: Sequence[TpuChip], process_bounds: str = "", chips_per_process_bounds: str = ""
) -> ContainerAllocation:
    """Payload for a whole-chip (``tpu-core``) container: exclusive chips,
    no memory cap."""
    envs = {
        const.ENV_TPU_VISIBLE_CHIPS: visible_chips_value([c.index for c in chips]),
    }
    if process_bounds:
        envs[const.ENV_TPU_PROCESS_BOUNDS] = process_bounds
    if chips_per_process_bounds:
        envs[const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS] = chips_per_process_bounds
    alloc = ContainerAllocation(envs=envs)
    for c in chips:
        if c.device_path:
            alloc.devices.append(
                DeviceMount(container_path=c.device_path, host_path=c.device_path)
            )
    return alloc


def build_gang_allocation(
    *,
    chips: Sequence[TpuChip],
    shape: Sequence[int],
    per_chip_units: int,
    chip_total_units: int,
    pod_units: int,
    container_units: int,
    disable_isolation: bool = False,
    workload_class: str = "",
    lora_adapter: str = "",
) -> ContainerAllocation:
    """Payload for a multi-chip gang container: every member chip visible,
    the granted shape as the single-process carve-out, and a PER-CHIP
    cooperative memory cap (each member holds ``per_chip_units`` of
    ``chip_total_units``).

    ``container_units`` is this container's share of the pod's TOTAL
    (cross-chip) request; its per-chip fraction scales accordingly so a
    two-container gang pod cannot double-claim a chip's slice.
    """
    shape3 = pad3(tuple(shape))
    envs = {
        const.ENV_TPU_VISIBLE_CHIPS: visible_chips_value([c.index for c in chips]),
        # one process owning the whole granted sub-slice
        const.ENV_TPU_PROCESS_BOUNDS: "1,1,1",
        const.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS: ",".join(str(d) for d in shape3),
        const.ENV_GANG_CHIPS: ",".join(str(c.index) for c in chips),
        const.ENV_GANG_SHAPE: format_shape(shape3),
        const.ENV_GANG_PER_CHIP: str(per_chip_units),
        const.ENV_MEM_POD: str(pod_units),
        const.ENV_MEM_CONTAINER: str(container_units),
        const.ENV_MEM_DEV: str(chip_total_units),
    }
    if workload_class:
        envs[const.ENV_WORKLOAD_CLASS] = workload_class
    if lora_adapter:
        envs[const.ENV_LORA_ADAPTER] = lora_adapter
    if disable_isolation:
        envs["CTPU_DISABLE"] = "true"
    elif chip_total_units > 0 and chips:
        units = container_units if container_units > 0 else pod_units
        per_chip = units / len(chips)
        frac = min(1.0, per_chip / chip_total_units)
        envs[const.ENV_XLA_MEM_FRACTION] = f"{frac:.4f}"
        envs[const.ENV_XLA_PYTHON_MEM_FRACTION] = f"{frac:.4f}"
    alloc = ContainerAllocation(envs=envs)
    for c in chips:
        if c.device_path:
            alloc.devices.append(
                DeviceMount(container_path=c.device_path, host_path=c.device_path)
            )
    return alloc
