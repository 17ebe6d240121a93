"""Discovery backend over ``torch.cuda``.

Counterpart of ``gpushare_device_plugin_tpu/discovery/jaxdev.py::JaxBackend``:
useful where a CUDA runtime is acceptable (a bench harness, a sidecar).
Chips come from ``torch.cuda``'s devices, ids from their UUIDs as NVML
writes them, memory from ``total_memory``. Not the daemon's default: a
process that asks ``torch.cuda`` opens a CUDA context, which holds
device memory that the pods were promised; the NVML backend opens none.

CUDA's index is not the card's device file: CUDA numbers the cards it
can see, while ``/dev/nvidia<minor>`` carries the driver's minor number
(a container granted a host's eighth card sees it as CUDA's 0 and as
``/dev/nvidia7``). The minor is read from the driver's entry for the
card's PCI bus id; where that entry is not readable the chip carries no
device path, and the env builder then mounts nothing rather than another
card's file.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Iterator, Sequence

from .base import ChipHealth, HealthEvent, TpuChip, TpuTopology

HEARTBEAT_S = 5.0  # between two heartbeats, as JaxBackend's poll
# The driver's directory of cards, one entry per PCI bus id, each with an
# ``information`` file that names its ``Device Minor``.
PROC_GPUS = "/proc/driver/nvidia/gpus"


def nvml_uuid(props: Any) -> str:
    """A device's UUID as NVML formats it: ``GPU-`` and the dashed hex."""
    raw = str(props.uuid)
    return raw if raw.startswith("GPU-") else f"GPU-{raw}"


def pci_bus_id(props: Any) -> str:
    """A device's PCI address as the driver's ``/proc`` entries name it
    (``0000:db:00.0``); "" where ``torch`` does not report it."""
    try:
        return (f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
                f"{props.pci_device_id:02x}.0")
    except AttributeError:
        return ""


def device_minor(proc_root: str, bus_id: str) -> int | None:
    """The card's minor number (the N of ``/dev/nvidiaN``) from the
    driver's ``<proc_root>/<bus id>/information``; None where it is not
    readable."""
    if not bus_id:
        return None
    try:
        with open(os.path.join(proc_root, bus_id, "information")) as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "Device Minor":
                    return int(value)
    except (OSError, ValueError):
        pass
    return None


class CudaBackend:
    def __init__(self, proc_root: str = PROC_GPUS):
        self._proc_root = proc_root

    def _torch(self) -> Any:
        import torch  # deferred: only this backend needs it

        return torch

    def probe(self) -> bool:
        try:
            torch = self._torch()
            return torch.cuda.is_available() and torch.cuda.device_count() > 0
        except Exception:  # noqa: BLE001 — a probe answers, never raises
            return False

    def chips(self) -> Sequence[TpuChip]:
        torch = self._torch()
        out = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            minor = device_minor(self._proc_root, pci_bus_id(props))
            out.append(
                TpuChip(
                    id=nvml_uuid(props),
                    index=i,
                    device_path="" if minor is None else f"/dev/nvidia{minor}",
                    hbm_bytes=props.total_memory,
                )
            )
        return out

    def topology(self) -> TpuTopology:
        torch = self._torch()
        n = torch.cuda.device_count()
        return TpuTopology(
            generation=torch.cuda.get_device_name(0) if n else "unknown",
            chips_per_host=n,
        )

    def watch_health(self, stop: Callable[[], bool]) -> Iterator[HealthEvent]:
        """Liveness poll: a small device allocation and a synchronize
        double as a runtime heartbeat."""
        torch = self._torch()
        last_ok = True
        while not stop():
            try:
                torch.zeros(1, device="cuda:0")
                torch.cuda.synchronize(0)
                ok = True
            except Exception:  # noqa: BLE001 — any failure is the signal
                ok = False
            if ok != last_ok:
                yield HealthEvent(
                    chip_id=None,
                    health=ChipHealth.HEALTHY if ok else ChipHealth.UNHEALTHY,
                    reason="cuda-runtime-heartbeat",
                )
                last_ok = ok
            time.sleep(HEARTBEAT_S)
