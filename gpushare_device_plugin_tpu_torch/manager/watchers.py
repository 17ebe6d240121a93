"""Kubelet-socket and device-plugin-dir watchers.

Counterpart of ``gpushare_device_plugin_tpu/manager/watchers.py``, copied.
Kubelet forgets every device plugin when it restarts, recreating its
socket; the plugin must see that and register again (upstream: an
fsnotify Create event on ``kubelet.sock`` triggers a full rebuild,
``gpumanager.go:83-87``). With no fsnotify binding, the watchers poll
signatures: a new inode or ctime (or fresh existence) at the same path
means the file was recreated.

``SocketWatcher`` watches one path (the original kubelet.sock check).
``PluginDirWatcher`` extends detection across the whole device-plugin
dir: besides the kubelet.sock signature it also notices *our own* plugin
sockets vanishing while kubelet.sock is alive. Some kubelet restarts and
node-agent cleanups wipe plugin sockets without recreating kubelet.sock
in a way the inode check can see (same inode number reused, coarse
ctime), and a plugin whose socket is gone is silently unregistered: no
more ListAndWatch, no more Allocate, forever. Either signal triggers the
same full rebuild and re-registration.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable


def _signature(path: str) -> tuple[int, int] | None:
    """(inode, ctime_ns): inode alone is unreliable — filesystems reuse
    inodes immediately after unlink+create."""
    try:
        st = os.stat(path)
        return (st.st_ino, st.st_ctime_ns)
    except OSError:
        return None


class SocketWatcher:
    def __init__(self, path: str, poll_interval_s: float = 0.5):
        self._path = path
        self._interval = poll_interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _signature(self) -> tuple[int, int] | None:
        return _signature(self._path)

    def start(self, on_recreate: Callable[[], None]) -> None:
        """Invoke ``on_recreate`` whenever the socket is recreated (new
        signature or fresh appearance) — the kubelet-restart signal."""
        last = self._signature()

        def run():
            nonlocal last
            while not self._stop.wait(self._interval):
                cur = self._signature()
                if cur is not None and cur != last:
                    on_recreate()
                last = cur

        self._thread = threading.Thread(target=run, daemon=True, name="sock-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


class PluginDirWatcher:
    """Watch kubelet.sock recreation AND our plugin sockets' disappearance.

    The manager suspends the watcher around its own rebuilds (it unlinks
    and recreates the plugin sockets itself — that churn must not read as
    a kubelet restart and loop the rebuild forever) and resumes once the
    new sockets are serving.

    A plugin socket must be missing for two consecutive polls before it
    fires: an atomic-ish external recreate (unlink+bind by somebody else)
    is not a gap we need to chase, and the debounce makes the check immune
    to sub-poll races with legitimate churn.
    """

    def __init__(
        self,
        kubelet_sock_path: str,
        plugin_sockets_fn: Callable[[], Iterable[str]],
        poll_interval_s: float = 0.5,
    ):
        self._kubelet_path = kubelet_sock_path
        self._plugins_fn = plugin_sockets_fn
        self._interval = poll_interval_s
        self._stop = threading.Event()
        self._suspended = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_kubelet = _signature(kubelet_sock_path)
        self._missing_streak: dict[str, int] = {}

    def suspend(self) -> None:
        """Stop triggering while the manager rebuilds the plugins."""
        self._suspended.set()

    def resume(self) -> None:
        """Watch again after a rebuild. Only the plugin-socket streaks are
        reset — the rebuild's socket churn was ours. The kubelet.sock
        signature is deliberately NOT re-seeded: we never touch that file,
        so a change observed across the suspended window is a real kubelet
        restart (possibly after our register() call, which the new kubelet
        has forgotten) and must still fire on the next poll."""
        self._missing_streak.clear()
        self._suspended.clear()

    def start(self, on_recreate: Callable[[str], None]) -> None:
        """``on_recreate(reason)`` fires on either restart signal."""

        def run():
            while not self._stop.wait(self._interval):
                if self._suspended.is_set():
                    continue
                cur = _signature(self._kubelet_path)
                if cur is not None and cur != self._last_kubelet:
                    self._last_kubelet = cur
                    self._missing_streak.clear()
                    on_recreate("kubelet.sock recreated")
                    continue
                self._last_kubelet = cur
                if cur is None:
                    # kubelet itself is down: re-registering is pointless
                    # until its socket returns (which the check above sees)
                    continue
                fired = False
                for path in list(self._plugins_fn()):
                    if os.path.exists(path):
                        self._missing_streak.pop(path, None)
                        continue
                    streak = self._missing_streak.get(path, 0) + 1
                    self._missing_streak[path] = streak
                    if streak >= 2 and not fired:
                        fired = True
                        self._missing_streak.clear()
                        on_recreate(f"plugin socket {os.path.basename(path)} vanished")
                        break

        self._thread = threading.Thread(target=run, daemon=True, name="plugindir-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
