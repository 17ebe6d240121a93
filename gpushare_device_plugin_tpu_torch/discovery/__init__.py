"""Card / memory enumeration backends.

Counterpart of ``gpushare_device_plugin_tpu/discovery/``. On a CUDA host
the cards are found through NVML (``nvmldev.NvmlBackend``, the
production backend, no CUDA context) or through ``torch.cuda``
(``cudadev.CudaBackend``); the config-driven mock runs the plugin's whole
cycle on a host with no card.
"""

from .base import ChipHealth, DiscoveryBackend, HealthEvent, TpuChip, TpuTopology
from .mock import MockBackend

__all__ = [
    "ChipHealth",
    "DiscoveryBackend",
    "HealthEvent",
    "TpuChip",
    "TpuTopology",
    "MockBackend",
    "from_name",
]


def from_name(name: str, **kwargs) -> DiscoveryBackend:
    """Build a backend by flag value (``--discovery=mock|nvml|cuda|auto``)."""
    if name == "mock":
        return MockBackend(**kwargs)
    if name == "nvml":
        from .nvmldev import NvmlBackend

        return NvmlBackend(**kwargs)
    if name == "cuda":
        from .cudadev import CudaBackend

        return CudaBackend(**kwargs)
    if name == "auto":
        # Best real backend that probes OK; else an empty mock, which makes
        # the daemon park (upstream's behavior on driverless nodes,
        # gpumanager.go:36-47) instead of crash-looping. Backend-specific
        # kwargs are not forwarded in auto mode; any probe failure falls
        # through rather than crashing.
        for load in (_load_nvml, _load_cuda):
            try:
                be = load()
                if be.probe():
                    return be
            except Exception:
                continue
        return MockBackend(num_chips=0)
    raise ValueError(f"unknown discovery backend {name!r}")


def _load_nvml() -> DiscoveryBackend:
    from .nvmldev import NvmlBackend

    return NvmlBackend()


def _load_cuda() -> DiscoveryBackend:
    from .cudadev import CudaBackend

    return CudaBackend()
