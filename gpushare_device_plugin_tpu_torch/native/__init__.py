"""Native boundaries of the device plugin: NVML through ``ctypes``."""
