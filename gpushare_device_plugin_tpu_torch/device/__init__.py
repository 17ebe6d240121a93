"""Where the port runs, and the device plugin's fan-out of a card into
memory-unit devices.

:func:`resolve_device`: ``cuda`` by default, the CPU only when asked.
:mod:`.fanout`: the counterpart of ``gpushare_device_plugin_tpu/device/``.
Importing this package imports no ``torch``: the plugin's node agent
uses the fan-out, and a DaemonSet has no use for PyTorch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from .fanout import (
    DeviceInventory,
    FakeDevice,
    extract_real_chip_id,
    generate_fake_device_id,
)

if TYPE_CHECKING:
    import torch

__all__ = [
    "DeviceInventory",
    "FakeDevice",
    "extract_real_chip_id",
    "generate_fake_device_id",
    "resolve_device",
]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a usable card
    raises: the port never drops to the CPU unless the caller passes
    ``"cpu"``."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
