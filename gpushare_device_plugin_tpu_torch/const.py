"""Constants the port shares with the reference's ``const.py``.

Copies, not imports: the port imports nothing of the reference package.
The env names stay the plugin's own (``TPU_VISIBLE_CHIPS``,
``ALIYUN_COM_TPU_MEM_*``, ...), because that is what the device plugin's
Allocate() injects into a pod, whatever card the pod runs on
(``parallel/podenv.py`` reads them).
"""

from __future__ import annotations

import enum

# --- Extended resource names (reference const.py:13-17) --------------------
# Fractional device memory, counted in memory units (one fake device a unit).
RESOURCE_MEM = "aliyun.com/tpu-mem"
# Whole-chip resource for pods that want exclusive chips.
RESOURCE_CORE = "aliyun.com/tpu-core"

# --- Device-plugin sockets (reference const.py:34-39) -----------------------
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"
KUBELET_SOCKET = DEVICE_PLUGIN_PATH + "kubelet.sock"
MEM_SOCKET_NAME = "aliyuntpushare.sock"
CORE_SOCKET_NAME = "aliyuntpucore.sock"
API_VERSION = "v1beta1"

# --- The memory-slice env the plugin injects (reference const.py:49-60) ----
ENV_MEM_IDX = "ALIYUN_COM_TPU_MEM_IDX"  # assigned physical chip index
ENV_MEM_POD = "ALIYUN_COM_TPU_MEM_POD"  # this pod's tpu-mem request
ENV_MEM_CONTAINER = "ALIYUN_COM_TPU_MEM_CONTAINER"  # container's request
ENV_MEM_DEV = "ALIYUN_COM_TPU_MEM_DEV"  # total units on the assigned chip

# --- Multi-chip gang grant (reference const.py:93-95) -----------------------
ENV_GANG_CHIPS = "ALIYUN_COM_TPU_GANG_CHIPS"
ENV_GANG_SHAPE = "ALIYUN_COM_TPU_GANG_SHAPE"
ENV_GANG_PER_CHIP = "ALIYUN_COM_TPU_GANG_PER_CHIP"

# --- Workload env (reference const.py:102-104, 121) -------------------------
ENV_TPU_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"
ENV_TPU_PROCESS_BOUNDS = "TPU_PROCESS_BOUNDS"
ENV_TPU_CHIPS_PER_PROCESS_BOUNDS = "TPU_CHIPS_PER_PROCESS_BOUNDS"
# The plugin's cooperative memory cap, a fraction of the chip, and the
# same value under the JAX client's name (reference const.py:121-122).
ENV_XLA_MEM_FRACTION = "TPU_HBM_LIMIT_FRACTION"
ENV_XLA_PYTHON_MEM_FRACTION = "XLA_PYTHON_CLIENT_MEM_FRACTION"
# What the port sets from TPU_VISIBLE_CHIPS (configure_torch_from_env).
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
# CUDA numbers cards fastest first unless this is PCI_BUS_ID; NVML, and so
# the plugin's chip index, numbers them by PCI bus id.
ENV_CUDA_DEVICE_ORDER = "CUDA_DEVICE_ORDER"
CUDA_DEVICE_ORDER_PCI = "PCI_BUS_ID"

# --- Multi-host bootstrap (reference const.py:115-117) ----------------------
# parallel/podenv.py::initialize_multihost reads them.
ENV_COORDINATOR_ADDRESS = "TPUSHARE_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPUSHARE_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUSHARE_PROCESS_ID"

# --- Workload classes (reference const.py:146-149) --------------------------
# Unknown or absent values normalize to latency-critical: the safe default
# is to protect, never to throttle.
WORKLOAD_LATENCY_CRITICAL = "latency-critical"
WORKLOAD_BEST_EFFORT = "best-effort"
WORKLOAD_CLASSES = (WORKLOAD_LATENCY_CRITICAL, WORKLOAD_BEST_EFFORT)
ENV_WORKLOAD_CLASS = "ALIYUN_COM_TPU_WORKLOAD_CLASS"

# Per-tenant LoRA adapter id (reference const.py:159): "" = the base model.
ENV_LORA_ADAPTER = "ALIYUN_COM_TPU_LORA_ADAPTER"

# SLO tier names: latency-critical requests admit ahead of best-effort ones.
SLO_TIER_CRITICAL = "critical"
SLO_TIER_BEST_EFFORT = "best_effort"

# --- Fleet replica lifecycle (reference const.py:176-185) -------------------
# ready -> routable; cordoned -> serving its in-flight work but closed to
# new routes (the scale-down protocol's first durable step); draining ->
# snapshot capture in progress; dead -> the failure detector evicted it
# (consecutive scrape misses) or scale-down released it.
FLEET_REPLICA_READY = "ready"
FLEET_REPLICA_CORDONED = "cordoned"
FLEET_REPLICA_DRAINING = "draining"
FLEET_REPLICA_DEAD = "dead"
FLEET_REPLICA_STATES = (
    FLEET_REPLICA_READY,
    FLEET_REPLICA_CORDONED,
    FLEET_REPLICA_DRAINING,
    FLEET_REPLICA_DEAD,
)


class MemoryUnit(str, enum.Enum):
    """Granularity of one unit of ``aliyun.com/tpu-mem`` (reference
    ``const.py:222``): GiB unless the cluster runs ``--memory-unit=MiB``."""

    GiB = "GiB"
    MiB = "MiB"

    @property
    def num_bytes(self) -> int:
        return 1 << 30 if self is MemoryUnit.GiB else 1 << 20


def translate_memory_units(value: str | None) -> MemoryUnit:
    """Validate a ``--memory-unit`` flag value, defaulting to GiB
    (reference ``const.py:233``; upstream ``cmd/nvidia/main.go:67-78``)."""
    if value is None or value == "":
        return MemoryUnit.GiB
    try:
        return MemoryUnit(value)
    except ValueError:
        raise ValueError(
            f"invalid memory unit {value!r}: expected one of "
            f"{[u.value for u in MemoryUnit]}"
        ) from None

# "<generation>:<incarnation token>": the newest instance stamps its
# journal's generation and a random per-open token on the node here; an
# instance observing a higher generation, or its own under a foreign
# token, is stale and refuses journal writes (allocator/checkpoint.py).
ANN_FENCE_GENERATION = "tpushare.aliyun.com/fence-generation"
