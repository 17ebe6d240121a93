"""The port's flight recorder (gpushare_device_plugin_tpu_torch:
``utils/flightrec.py``, with the fatal path of ``utils/log.py``, the crash
hook of ``utils/faults.py``, ``utils/timeline.py`` and
``utils/stacktrace.py``) against the reference's ``FlightRecorder``.

Both recorders take the same log lines (one logger, both rings on it):
the rings keep the same newest entries, dumps carry the same keys and
log entries, rotation keeps the same newest files, ``Logger.fatal`` and an
injected crash dump through the hooks ``install`` registers, and
``uninstall`` takes every hook and the handler away again. Every hook a
test installs is uninstalled in a ``finally``: the recorders, the fatal
hooks and the crash hooks are process-wide.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import pytest

from gpushare_device_plugin_tpu.utils import faults as JF
from gpushare_device_plugin_tpu.utils import flightrec as JR
from gpushare_device_plugin_tpu.utils import log as JL
from gpushare_device_plugin_tpu.utils import stacktrace as JS
from gpushare_device_plugin_tpu.utils import timeline as JT
from gpushare_device_plugin_tpu.utils import tracing as JTr
from gpushare_device_plugin_tpu_torch.utils import faults as F
from gpushare_device_plugin_tpu_torch.utils import flightrec as R
from gpushare_device_plugin_tpu_torch.utils import log as L
from gpushare_device_plugin_tpu_torch.utils import stacktrace as S
from gpushare_device_plugin_tpu_torch.utils import timeline as T
from gpushare_device_plugin_tpu_torch.utils import tracing as Tr

PORT = dict(name="port", rec=R, log=L, faults=F, tracing=Tr)
REF = dict(name="ref", rec=JR, log=JL, faults=JF, tracing=JTr)
BOTH = (PORT, REF)


@pytest.fixture
def recorders(tmp_path):
    """A recorder of each package on one private logger (DEBUG, not
    propagating), each dumping into its own dir; uninstalled at the end."""
    logger = logging.getLogger(f"flightrec-parity-{id(tmp_path)}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    made = []

    def make(**kw):
        out = []
        for pkg in BOTH:
            rec = pkg["rec"].FlightRecorder(store=pkg["tracing"].TraceStore(), **kw)
            rec.install(str(tmp_path / pkg["name"]), logger=logger)
            made.append((pkg, rec))
            out.append(rec)
        return out

    try:
        yield logger, make
    finally:
        for pkg, rec in made:
            rec.uninstall(logger=logger)
        for pkg in BOTH:
            pkg["faults"].FAULTS.clear()


def _entries(logs):
    return [{k: v for k, v in e.items() if k != "time_unix"} for e in logs]


def test_the_ring_keeps_the_same_newest_lines(recorders):
    logger, make = recorders
    port, ref = make(max_logs=4)
    for i in range(7):
        logger.log([logging.DEBUG, logging.INFO, logging.WARNING][i % 3], "line %d of %s", i, "x")
    assert _entries(port.recent_logs()) == _entries(ref.recent_logs())
    got = _entries(port.recent_logs())
    assert [e["message"] for e in got] == [f"line {i} of x" for i in range(3, 7)]
    assert got[0]["level"] == "DEBUG" and got[0]["trace_id"] == ""
    logger.info("bad %d", "args")  # mismatched format args keep the raw message
    assert port.recent_logs()[-1]["message"] == ref.recent_logs()[-1]["message"] == "bad %d"


def test_a_dump_is_the_reference_document(recorders, tmp_path):
    logger, make = recorders
    port, ref = make()
    logger.warning("admission slow: %s", "pod-a")
    docs = []
    for rec in (port, ref):
        path = rec.dump("SIGUSR1")
        assert os.path.basename(path).startswith("tpushare-flightrec-")
        assert path.endswith("-SIGUSR1.json") and rec.dump_count == 1
        with open(path) as f:
            docs.append(json.load(f))
    assert sorted(docs[0]) == sorted(docs[1]) == sorted(
        ["reason", "time_unix", "pid", "service", "trace_count", "dropped_traces", "traces",
         "logs", "timeline"])
    for key in ("reason", "pid", "service", "trace_count", "dropped_traces"):
        assert docs[0][key] == docs[1][key], key
    assert _entries(docs[0]["logs"]) == _entries(docs[1]["logs"])
    assert docs[0]["timeline"].keys() == docs[1]["timeline"].keys()
    path = port.dump("x")
    assert R.load_dump(path) == JR.load_dump(path)


def test_rotation_keeps_the_newest_dumps(recorders, tmp_path):
    logger, make = recorders
    port, ref = make(max_dumps=3)
    left = []
    for pkg, rec in zip(BOTH, (port, ref)):
        for i in range(5):
            rec.dump(f"r{i}")
            time.sleep(0.01)  # distinct mtimes
        # a file of another kind is never pruned
        (tmp_path / pkg["name"] / "tpushare-flightrec-notes.txt").write_text("keep")
        rec.dump("r5")
        left.append(sorted(os.listdir(tmp_path / pkg["name"])))
    names = [[n.rsplit("-", 1)[-1] for n in names] for names in left]
    assert names[0] == names[1] == ["r3.json", "r4.json", "r5.json", "notes.txt"]


def test_fatal_and_crash_hooks_dump_and_uninstall_removes_them(recorders, tmp_path):
    logger, make = recorders
    port, ref = make()
    for pkg in BOTH:
        with pytest.raises(SystemExit) as err:
            pkg["log"].get_logger("daemon").fatal("no node %s", "name")
        assert err.value.code == 255
        faults = pkg["faults"]
        faults.FAULTS.inject("checkpoint.begin", "crash", times=1)
        with pytest.raises(faults.SimulatedCrash):
            faults.FAULTS.fire("checkpoint.begin")
        faults.FAULTS.fire("checkpoint.begin")  # the one crash is spent
    reasons = [sorted(R.load_dump(str(tmp_path / pkg["name"] / n))["reason"]
                      for n in os.listdir(tmp_path / pkg["name"])) for pkg in BOTH]
    assert reasons[0] == reasons[1] == ["crash:checkpoint.begin", "fatal:no node name"]
    for rec in (port, ref):
        rec.uninstall(logger=logger)
    for pkg, rec in zip(BOTH, (port, ref)):
        with pytest.raises(SystemExit):
            pkg["log"].get_logger("daemon").fatal("after uninstall")
        pkg["faults"].FAULTS.inject("checkpoint.begin", "crash", times=1)
        with pytest.raises(pkg["faults"].SimulatedCrash):
            pkg["faults"].FAULTS.fire("checkpoint.begin")
        logger.info("not recorded")
        assert len(os.listdir(tmp_path / pkg["name"])) == 2
        assert "not recorded" not in [e["message"] for e in rec.recent_logs()]


def test_a_failing_hook_and_a_sick_disk_do_not_hurt_the_dying(tmp_path):
    """A raising fatal hook still exits 255; a dump into an unwritable
    place returns '' instead of raising; a raising crash hook still
    crashes. The signal handler installs only on the main thread."""
    for pkg in BOTH:
        log, faults = pkg["log"], pkg["faults"]
        rec = pkg["rec"].FlightRecorder(store=pkg["tracing"].TraceStore())
        (tmp_path / "file").write_text("")
        rec.install(str(tmp_path / "file" / "sub"), logger=logging.getLogger("unused"))
        try:
            assert rec.dump("x") == ""
            log.on_fatal(lambda reason: 1 / 0)
            with pytest.raises(SystemExit):
                log.get_logger("daemon").fatal("boom")
            faults.FAULTS.set_crash_hook(lambda point: 1 / 0)
            faults.FAULTS.inject("checkpoint.commit", "crash", times=1)
            with pytest.raises(faults.SimulatedCrash):
                faults.FAULTS.fire("checkpoint.commit")
            installed = []
            t = threading.Thread(target=lambda: installed.append(rec.install_signal_handler()))
            t.start()
            t.join(5)
            assert installed == [False]
        finally:
            rec.uninstall(logger=logging.getLogger("unused"))
            faults.FAULTS.clear()


def test_timeline_and_stack_dump_match_the_reference(tmp_path):
    """The ring the flight record embeds folds samples into buckets alike
    (last write wins, gaps read as missing), and SIGQUIT's stack dump
    names every thread."""
    docs = []
    for mod in (T, JT):
        tl = mod.ClusterTimeline(bucket_s=10.0, buckets=4, clock=lambda: 0.0)
        for t, util in ((0, 1.0), (5, 2.0), (12, 3.0), (41, 4.0), (55, 5.0)):
            tl.sample(now=t, util_pct=util)
        tl.sample(now=55, **{f"f{i}": i for i in range(40)})  # the field cap
        loop = mod.TimelineLoop(tl, {"a": lambda: 7, "b": lambda: {"x": 1, "y": "bad"},
                                     "c": lambda: None, "d": lambda: 1 / 0})
        docs.append((tl.to_doc(), len(tl.fields()), loop.run_once()))
    assert docs[0] == docs[1]
    assert docs[0][0]["series"]["util_pct"] == [[40.0, 4.0], [50.0, 5.0]]
    assert docs[0][1] == 32 and docs[0][2] == {"a": 7.0, "x": 1.0}
    path = S.coredump(str(tmp_path))
    with open(path) as f:
        text = f.read()
    me = f"--- thread {threading.current_thread().name} ({threading.get_ident()}) ---"
    assert os.path.basename(path).startswith("tpushare_") and me in text
    assert me in JS.stack_trace()
