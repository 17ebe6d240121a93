"""Run a reference cluster-mode test against both packages and compare.

``load(test_file, pkg)`` reads ``tests/<test_file>.py`` and executes it as
a new module whose imports of ``gpushare_device_plugin_tpu.X`` point at
``<pkg>.X`` wherever the port has that module (a module the port lacks,
such as the JAX workloads', stays the reference's) and wherever the caller
does not ask to ``keep`` the reference's module. The scheduler extender is
the port's own in the port's column, so a mirrored case admits the port's
extender's bindings through the port's allocator. ``run_case`` calls one
test function the way pytest would (its module fixtures, autouse ones
included, plus ``tmp_path``, ``monkeypatch`` and ``capsys``), so the
reference's own assertions run against the port. Around the call it
records what each package did on the wire: every ``FakeApiServer`` the case started (its
PATCH bodies, pod and node annotations and labels, events, bindings) and
every ``ClusterAllocator`` / ``ClusterCoreAllocator`` Allocate (the envs
returned, or the refusal), and everything the case printed (a CLI's
render, read through ``capsys``). ``mirror_case`` runs a case under both
packages and asserts the two records are equal, after timestamps, trace
ids, fence tokens, uids, the measured durations in the defrag-status and
interference node annotations and the clock times a CLI prints are reduced
to their form (in what a case printed: clock times, trace ids and a
record's ``time_unix``; decision-record ids count from the first printed).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import importlib.util
import inspect
import io
import itertools
import json
import re
import types
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest

import fake_apiserver

REF = "gpushare_device_plugin_tpu"
PORT = "gpushare_device_plugin_tpu_torch"
TESTS = Path(__file__).resolve().parent

_MODULES: dict[tuple[str, str, tuple[str, ...]], types.ModuleType] = {}


def _port_has(module: str) -> bool:
    try:
        return importlib.util.find_spec(module) is not None
    except ModuleNotFoundError:
        return False


def load(test_file: str, pkg: str, keep: tuple[str, ...] = ()) -> types.ModuleType:
    """``tests/<test_file>.py`` executed with its imports on ``pkg``, but for
    the reference modules named in ``keep`` (``"utils.metrics"``)."""
    key = (test_file, pkg, keep)
    if key in _MODULES:
        return _MODULES[key]
    path = TESTS / f"{test_file}.py"
    src = path.read_text()
    if pkg == PORT:
        def to_port(m: re.Match) -> str:
            target = PORT + m.group(1)
            if m.group(1).lstrip(".") in keep or not _port_has(target):
                return m.group(0)
            return target

        src = re.sub(rf"\b{REF}((?:\.\w+)*)", to_port, src)
    mod = types.ModuleType(f"_mirror_{pkg}_{test_file}_{'_'.join(keep)}")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    _MODULES[key] = mod
    return mod


def cases(test_file: str, names: list[str]) -> list:
    """``pytest.param``s, one per test and parametrize value, named like
    pytest names them."""
    mod = load(test_file, REF)
    out = []
    for name in names:
        fn = getattr(mod, name)
        grids = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not grids:
            out.append(pytest.param(name, {}, id=name))
            continue
        axes = []
        for mark in grids:
            argnames = mark.args[0]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            values = [v if len(argnames) > 1 else (v,) for v in mark.args[1]]
            axes.append([dict(zip(argnames, v)) for v in values])
        for combo in itertools.product(*axes):
            params = {k: v for d in combo for k, v in d.items()}
            ident = "-".join(str(v) for v in params.values())
            out.append(pytest.param(name, params, id=f"{name}[{ident}]"))
    return out


# --- one case under one package -------------------------------------------


class _FastServer(ThreadingHTTPServer):
    """The fake apiserver's HTTP server with a 20 ms shutdown poll (the
    default 0.5 s would dominate every case's teardown)."""

    def serve_forever(self, poll_interval: float = 0.02) -> None:
        super().serve_forever(poll_interval)


class _Capture:
    """``capsys`` for a mirrored case: stdout and stderr redirected for the
    case; ``readouterr`` returns and clears what was written, and
    ``log`` keeps every read (and, at the end, the rest) for the record."""

    def __init__(self, stack):
        self._out, self._err = io.StringIO(), io.StringIO()
        self.log: list[tuple[str, str]] = []
        stack.callback(self.readouterr)
        stack.enter_context(contextlib.redirect_stdout(self._out))
        stack.enter_context(contextlib.redirect_stderr(self._err))

    def readouterr(self):
        got = (self._out.getvalue(), self._err.getvalue())
        for buf in (self._out, self._err):
            buf.seek(0)
            buf.truncate()
        if any(got):
            self.log.append(got)
        return _Read(*got)


@dataclasses.dataclass
class _Read:
    out: str
    err: str


def _fixture(mod, name, given, cache, stack, tmp_factory):
    if name in given:
        return given[name]
    if name in cache:
        return cache[name]
    if name == "tmp_path":
        value = tmp_factory.mktemp("mirror")
    elif name == "monkeypatch":
        value = pytest.MonkeyPatch()
        stack.callback(value.undo)
    elif name == "capsys":
        value = _Capture(stack)
    else:
        fx = getattr(mod, name)
        value = _call(mod, fx._get_wrapped_function(), given, cache, stack, tmp_factory)
        if inspect.isgenerator(value):
            gen = value
            value = next(gen)
            stack.callback(next, gen, None)
    cache[name] = value
    return value


def _call(mod, fn, given, cache, stack, tmp_factory):
    kwargs = {
        p: _fixture(mod, p, given, cache, stack, tmp_factory)
        for p in inspect.signature(fn).parameters
    }
    return fn(**kwargs)


def _autouse(mod) -> list[str]:
    return [
        name for name, obj in vars(mod).items()
        if hasattr(obj, "_fixture_function_marker")
        and obj._fixture_function_marker.autouse
    ]


def _result_doc(res) -> list:
    return [
        dataclasses.asdict(c) if dataclasses.is_dataclass(c) else repr(c)
        for c in res
    ]


def run_case(pkg: str, test_file: str, name: str, params: dict, tmp_factory,
             keep: tuple[str, ...] = ()) -> dict:
    """Run one case under ``pkg``; -> what it did on the wire."""
    mod = load(test_file, pkg, keep)
    cluster = importlib.import_module(f"{pkg}.allocator.cluster")
    servers: list = []
    allocations: list = []
    with contextlib.ExitStack() as stack:
        mp = pytest.MonkeyPatch()
        stack.callback(mp.undo)
        mp.setattr(fake_apiserver, "ThreadingHTTPServer", _FastServer)
        init = fake_apiserver.FakeApiServer.__init__

        def recording_init(self, *a, **kw):
            init(self, *a, **kw)
            servers.append(self)

        mp.setattr(fake_apiserver.FakeApiServer, "__init__", recording_init)
        for cls in (cluster.ClusterAllocator, cluster.ClusterCoreAllocator):
            def wrap(orig, kind=cls.__name__):
                def allocate(self, granted):
                    try:
                        res = orig(self, granted)
                    except Exception as e:
                        allocations.append((kind, "refused", type(e).__name__, str(e)))
                        raise
                    allocations.append((kind, "ok", _result_doc(res)))
                    return res
                return allocate

            mp.setattr(cls, "allocate", wrap(cls.allocate))
        cache: dict = {}
        for auto in _autouse(mod):
            _fixture(mod, auto, params, cache, stack, tmp_factory)
        _call(mod, getattr(mod, name), params, cache, stack, tmp_factory)
    capture = cache.get("capsys")
    return {
        "servers": [_server_doc(s) for s in servers],
        "allocations": allocations,
        "output": [[_text(text) for text in read]
                   for read in (capture.log if capture is not None else [])],
    }


def _text(text: str) -> str:
    """What a case printed, its clock times and trace ids by form, and its
    decision-record ids from the first one printed (the ring numbers the
    records of the whole process, so a case's first id depends on the
    tests that ran before it in the worker)."""
    text = _CLOCK.sub("<hh:mm:ss>", text)
    text = _TRACE_TEXT.sub("<trace>", text)
    text = _TIME_TEXT.sub('"time_unix": "<time>"', text)
    ids = [int(m.group(2) or m.group(4)) for m in _RECORD_ID.finditer(text)]
    if not ids or ("decision record" not in text and '"verb": ' not in text):
        return text
    first = ids[0]
    return _RECORD_ID.sub(
        lambda m: f"{m.group(1) or m.group(3)}+{int(m.group(2) or m.group(4)) - first}", text)


def _server_doc(srv) -> dict:
    with srv._lock:
        return {
            "patches": copy.deepcopy(srv.patch_log),
            "pods": {
                "/".join(k): {
                    "annotations": p.get("metadata", {}).get("annotations") or {},
                    "labels": p.get("metadata", {}).get("labels") or {},
                    "node": p.get("spec", {}).get("nodeName", ""),
                    "phase": p.get("status", {}).get("phase", ""),
                }
                for k, p in sorted(srv.pods.items())
            },
            "nodes": copy.deepcopy(srv.nodes),
            "events": copy.deepcopy(srv.events),
            "bindings": list(srv.bindings),
        }


# --- comparison --------------------------------------------------------------

_NS = re.compile(r"^\d{16,20}$")
_TRACE = re.compile(r"^[0-9a-f]{32}:[0-9a-f]{16}$")
_FENCE = re.compile(r"^(\d+):[0-9a-zA-Z_-]+$")
_TS_KEYS = {"firstTimestamp", "lastTimestamp", "eventTime", "time_unix"}
_CLOCK = re.compile(r"\b\d\d:\d\d:\d\d\b")  # the `top` view's refresh time
_TRACE_TEXT = re.compile(r"\b[0-9a-f]{32}\b")  # a trace id `inspect why` prints
_TIME_TEXT = re.compile(r'"time_unix": \d+(\.\d+)?')  # a record's clock, `-o json`
_RECORD_ID = re.compile(r'(\[#)(\d+)(?=\])|("id": )(\d+)')  # `inspect why`'s record ids
# node annotations holding JSON with a measured duration or a clock reading
_JSON_ANNOTATIONS = {
    "tpushare.aliyun.com/defrag-status": {"last_move_ms"},
    "tpushare.aliyun.com/interference": {"time_unix"},
}
_FORM_KEYS = {
    "ALIYUN_COM_TPU_MEM_ASSUME_TIME": (_NS, "<ns>"),
    "tpushare.aliyun.com/trace-id": (_TRACE, "<trace>"),
}


def normalize(doc):
    """Timestamps, trace ids, fence tokens and uids by form, not value: a
    value that does not have the form is kept, so the comparison fails."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if k in _FORM_KEYS and isinstance(v, str):
                pat, token = _FORM_KEYS[k]
                out[k] = token if pat.match(v) else v
            elif k in _JSON_ANNOTATIONS and isinstance(v, str):
                out[k] = _json_annotation(v, _JSON_ANNOTATIONS[k])
            elif k == "tpushare.aliyun.com/fence-generation" and isinstance(v, str):
                m = _FENCE.match(v)
                out[k] = f"{m.group(1)}:<token>" if m else v
            elif k in _TS_KEYS and isinstance(v, (str, int, float)):
                out[k] = "<time>"
            elif k == "uid":
                out[k] = "<uid>"
            else:
                out[k] = normalize(v)
        return out
    if isinstance(doc, (list, tuple)):
        return [normalize(v) for v in doc]
    return doc


def _json_annotation(raw: str, measured: set[str]):
    """A JSON annotation parsed, its ``measured`` fields that are positive
    numbers by form (a zero stays, so "never measured" still compares)."""
    try:
        doc = json.loads(raw)
    except ValueError:
        return raw
    if not isinstance(doc, dict):
        return raw
    return {
        k: "<measured>" if k in measured and isinstance(v, (int, float)) and v > 0 else v
        for k, v in doc.items()
    }


def mirror_case(test_file: str, name: str, params: dict, tmp_factory,
                compare=("servers", "allocations"), keep: tuple[str, ...] = ()
                ) -> tuple[dict, dict]:
    """The reference's test under the reference, then under the port; the
    two wire records must be equal (the ``compare`` parts of them)."""
    ref = normalize(run_case(REF, test_file, name, params, tmp_factory))
    port = normalize(run_case(PORT, test_file, name, params, tmp_factory, keep))
    for part in compare:
        if port[part] != ref[part]:
            a = json.dumps(ref[part], indent=1, sort_keys=True, default=repr)
            b = json.dumps(port[part], indent=1, sort_keys=True, default=repr)
            raise AssertionError(
                f"{part} differ between the packages\n--- reference\n{a}\n--- port\n{b}"
            )
    return ref, port
