"""The port's kubelet-socket and plugin-dir watchers
(gpushare_device_plugin_tpu_torch: ``manager/watchers.py``) side by side
with the reference's, on the same files in tmp dirs of their own.

Both must fire alike: on a recreated socket (new inode or ctime, or fresh
existence), on one of our plugin sockets missing two polls in a row while
kubelet.sock lives, never while suspended, on resume for a kubelet.sock
change made during the suspension, never for a vanished plugin socket
while kubelet.sock is gone, and never after stop. Every wait has a timeout.
"""

from __future__ import annotations

import os
import queue
import time

import pytest

from gpushare_device_plugin_tpu.manager import watchers as JW
from gpushare_device_plugin_tpu_torch.manager import watchers as W

POLL = 0.02
TIMEOUT = 5.0
QUIET = 0.3  # fifteen polls: long enough for a wrongly armed watcher to fire


def _touch(path):
    with open(path, "w") as f:
        f.write("x")


def _recreate(path):
    os.unlink(path)
    _touch(path)


def _events(q: queue.Queue, n: int) -> list:
    return [q.get(timeout=TIMEOUT) for _ in range(n)]


def _quiet(q: queue.Queue) -> list:
    time.sleep(QUIET)
    out = []
    while not q.empty():
        out.append(q.get_nowait())
    return out


@pytest.fixture
def pair(tmp_path):
    """Each package's watchers over its own dir; stopped at the end."""
    made = []

    def make(cls_name, **kw):
        out = []
        for name, mod in (("port", W), ("ref", JW)):
            root = tmp_path / name
            root.mkdir(exist_ok=True)
            q = queue.Queue()
            made.append(watcher := _make(mod, cls_name, root, q, **kw))
            out.append((root, q, watcher))
        return out

    yield make
    for watcher in made:
        watcher.stop()


def _make(mod, cls_name, root, q, **kw):
    if cls_name == "SocketWatcher":
        _touch(root / "kubelet.sock")
        w = mod.SocketWatcher(str(root / "kubelet.sock"), poll_interval_s=POLL)
        w.start(on_recreate=lambda: q.put("recreated"))
        return w
    w = mod.PluginDirWatcher(
        kubelet_sock_path=str(root / "kubelet.sock"),
        plugin_sockets_fn=lambda: [str(root / "a.sock"), str(root / "b.sock")],
        poll_interval_s=POLL,
    )
    if kw.get("kubelet", True):
        _touch(root / "kubelet.sock")
    _touch(root / "a.sock")
    _touch(root / "b.sock")
    if kw.get("seed", True):
        w._last_kubelet = mod._signature(str(root / "kubelet.sock"))

    def on_recreate(reason):
        # as the manager does: a rebuild suspends the watcher until its
        # new sockets serve (the test resumes it)
        w.suspend()
        q.put(reason)

    w.start(on_recreate=on_recreate)
    return w


def test_signature_catches_a_recreated_file_even_on_a_reused_inode(tmp_path):
    """The signature is (inode, ctime_ns): tmp filesystems hand the same
    inode back after unlink and create, and the ctime is what differs."""
    seen = []
    for mod in (W, JW):
        path = str(tmp_path / f"{mod.__name__}.sock")
        assert mod._signature(path) is None
        _touch(path)
        before = mod._signature(path)
        time.sleep(0.01)
        _recreate(path)
        after = mod._signature(path)
        seen.append((before is not None, after != before, after[1] > before[1]))
    assert seen[0] == seen[1] == (True, True, True)


def test_socket_watcher_fires_on_each_recreation_and_not_after_stop(pair):
    for root, q, w in pair("SocketWatcher"):
        assert _quiet(q) == []  # the same file: nothing
        _recreate(root / "kubelet.sock")
        assert _events(q, 1) == ["recreated"]
        os.unlink(root / "kubelet.sock")  # gone: nothing to fire on
        assert _quiet(q) == []
        _touch(root / "kubelet.sock")  # fresh existence
        assert _events(q, 1) == ["recreated"]
        w.stop()
        _recreate(root / "kubelet.sock")
        assert _quiet(q) == []


def test_plugin_dir_watcher_kubelet_recreation_and_vanished_socket(pair):
    seen = []
    for root, q, w in pair("PluginDirWatcher"):
        got = _quiet(q)
        _recreate(root / "kubelet.sock")
        got += _events(q, 1)
        w.resume()
        got += _quiet(q)  # kubelet.sock's new signature was taken when it fired
        os.unlink(root / "b.sock")
        got += _events(q, 1)
        _touch(root / "b.sock")  # the rebuild's new socket
        w.resume()
        got += _quiet(q)
        seen.append(got)
    assert seen[0] == seen[1] == ["kubelet.sock recreated", "plugin socket b.sock vanished"]


def test_plugin_dir_watcher_suspend_and_resume(pair):
    seen = []
    for root, q, w in pair("PluginDirWatcher"):
        w.suspend()
        _recreate(root / "a.sock")  # our own rebuild's churn
        os.unlink(root / "b.sock")
        _recreate(root / "kubelet.sock")  # a kubelet restart inside the window
        got = _quiet(q)
        _touch(root / "b.sock")
        w.resume()
        got += _events(q, 1)  # the kubelet.sock change still fires
        w.resume()  # after the rebuild
        got += _quiet(q)
        seen.append(got)
    assert seen[0] == seen[1] == ["kubelet.sock recreated"]


def test_plugin_dir_watcher_waits_for_kubelet_before_chasing_sockets(pair):
    seen = []
    for root, q, w in pair("PluginDirWatcher", kubelet=False, seed=False):
        os.unlink(root / "a.sock")  # kubelet down: re-registering is pointless
        got = _quiet(q)
        _touch(root / "kubelet.sock")  # kubelet back: that alone fires
        got += _events(q, 1)
        w.resume()
        got += _events(q, 1)  # and then the socket still missing
        w.stop()
        w.resume()
        _recreate(root / "kubelet.sock")  # stopped: nothing fires any more
        got += _quiet(q)
        seen.append(got)
    assert seen[0] == seen[1] == ["kubelet.sock recreated", "plugin socket a.sock vanished"]
