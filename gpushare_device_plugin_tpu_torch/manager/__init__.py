"""The node agent's managers: the daemon's lifecycle, standalone or in
cluster mode (``lifecycle``), the kubelet-socket and plugin-dir watchers
(``watchers``) and the health watcher (``health``)."""

from .health import HealthWatcher
from .lifecycle import ManagerConfig, TpuShareManager

__all__ = ["HealthWatcher", "ManagerConfig", "TpuShareManager"]
