"""NVML through ``ctypes``: the device plugin's view of the cards.

Counterpart of ``gpushare_device_plugin_tpu/native/tpuinfo.py`` (the
reference's lazily loaded shim over libtpu), and of upstream's ``dlopen``
of ``libnvidia-ml.so.1`` (``nvml_dl.c:21-27``): the driver's own library,
loaded at first use, so one DaemonSet image runs on a node without a
driver and simply parks.

This module imports no ``torch``. A DaemonSet that opened a CUDA context
would hold hundreds of MB of every card it advertises to the pods; NVML
reads the cards without one.

Every call checks NVML's return code and raises :class:`NvmlError` on a
failure (``code`` is NVML's ``nvmlReturn_t``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
# nvmlMemoryErrorType_t and nvmlEccCounterType_t
MEMORY_ERROR_CORRECTED = 0
MEMORY_ERROR_UNCORRECTED = 1
VOLATILE_ECC = 0
# NVML_DEVICE_UUID_V2_BUFFER_SIZE and NVML_DEVICE_NAME_V2_BUFFER_SIZE
_TEXT_BUFFER = 96


class _PciInfo(ctypes.Structure):
    """``nvmlPciInfo_t`` as ``nvmlDeviceGetPciInfo_v3`` fills it."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class _Memory(ctypes.Structure):
    """``nvmlMemory_t``: bytes."""

    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


# Every entry point this module calls, with its C argument types. nvml.h
# maps the unversioned nvmlDeviceGetPciInfo onto the _v3 symbol.
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)],
    "nvmlDeviceGetUUID": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMinorNumber": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetPciInfo_v3": [ctypes.c_void_p, ctypes.POINTER(_PciInfo)],
    "nvmlDeviceGetMemoryInfo": [ctypes.c_void_p, ctypes.POINTER(_Memory)],
    "nvmlDeviceGetTotalEccErrors": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
    ],
}


class NvmlError(OSError):
    """An NVML call returned something other than ``NVML_SUCCESS``."""

    def __init__(self, call: str, code: int, message: str = "") -> None:
        super().__init__(f"{call} failed: NVML error {code} {message}".rstrip())
        self.call = call
        self.code = code


@dataclasses.dataclass(frozen=True)
class NvmlDevice:
    """One card as NVML reports it."""

    index: int  # NVML's index
    uuid: str  # "GPU-xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx"
    name: str
    minor: int  # the N of /dev/nvidiaN
    pci_bus_id: str  # "00000000:18:00.0"; "" where the driver hides the bus
    memory_total: int  # bytes


class Nvml:
    """An initialized NVML over a loaded library (``ctypes.CDLL`` or an
    object with the same entry points)."""

    def __init__(self, lib: Any) -> None:
        self._lib = lib
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._error_string = getattr(lib, "nvmlErrorString", None)
        if self._error_string is not None:
            self._error_string.argtypes = [ctypes.c_int]
            self._error_string.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")

    def _call(self, name: str, *args: Any) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != NVML_SUCCESS:
            message = ""
            if self._error_string is not None:
                message = (self._error_string(rc) or b"").decode(errors="replace")
            raise NvmlError(name, rc, message)

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def _handle(self, index: int) -> ctypes.c_void_p:
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(handle))
        return handle

    def _text(self, call: str, handle: ctypes.c_void_p) -> str:
        buf = ctypes.create_string_buffer(_TEXT_BUFFER)
        self._call(call, handle, buf, _TEXT_BUFFER)
        return buf.value.decode()

    def device(self, index: int) -> NvmlDevice:
        handle = self._handle(index)
        minor = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(minor))
        pci = _PciInfo()
        try:
            self._call("nvmlDeviceGetPciInfo_v3", handle, ctypes.byref(pci))
        except NvmlError as e:
            # a virtualized driver answers NOT_SUPPORTED: the card is there,
            # only its bus is hidden (busId stays empty)
            if e.code != NVML_ERROR_NOT_SUPPORTED:
                raise
        mem = _Memory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(mem))
        return NvmlDevice(
            index=index,
            uuid=self._text("nvmlDeviceGetUUID", handle),
            name=self._text("nvmlDeviceGetName", handle),
            minor=minor.value,
            pci_bus_id=pci.busId.decode(),
            memory_total=mem.total,
        )

    def devices(self) -> list[NvmlDevice]:
        return [self.device(i) for i in range(self.device_count())]

    def ecc_errors(self, index: int) -> tuple[int, int]:
        """The card's volatile ECC counts since the driver loaded:
        (corrected, uncorrected). Raises :class:`NvmlError` with
        ``NVML_ERROR_NOT_SUPPORTED`` where ECC is off."""
        handle = self._handle(index)
        out = []
        for kind in (MEMORY_ERROR_CORRECTED, MEMORY_ERROR_UNCORRECTED):
            n = ctypes.c_ulonglong()
            self._call("nvmlDeviceGetTotalEccErrors", handle, kind, VOLATILE_ECC,
                       ctypes.byref(n))
            out.append(n.value)
        return out[0], out[1]

    def shutdown(self) -> None:
        self._call("nvmlShutdown")


def load(path: str | None = None) -> Nvml:
    """Load and initialize NVML (``libnvidia-ml.so.1`` from the system's
    search path unless ``path`` names a library). Raises ``OSError`` when
    the library is absent or ``nvmlInit_v2`` fails."""
    return Nvml(ctypes.CDLL(path or LIBRARY))
