"""The node agent's managers: the health watcher (``health``). The
daemon's lifecycle and watchers come in a later slice."""

from .health import HealthWatcher

__all__ = ["HealthWatcher"]
