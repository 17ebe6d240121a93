"""Run the reference's model checker (``tools/tpumc``) over the port.

``load()`` reads ``tools/tpumc/{sched,explore,memwal,models}.py`` and
executes them, unedited but for one name, as a fresh package
(:data:`NAME`): every ``gpushare_device_plugin_tpu.X`` import in them, at
module level or inside a function (``sched.mc_session`` takes ``lockrank``
and ``FAULTS`` there), names ``gpushare_device_plugin_tpu_torch.X``. So the
scheduler installs its cooperative primitives through the port's
``lockrank.set_mc_factory`` and its yield hook through the port's
``FAULTS.set_yield_hook``, and each model builds the port's own classes:
its ``DrainHandshake``, ``ShardRouter`` and ``ShardExtender``,
``SliceMover``, ``AssumeCache``, ``HandoffMover`` and its ledger,
``ScaleExecutor`` and ``PageAllocator``. The handoff model's
``PageAllocator`` comes from the port's ``serving/pages.py``, which takes
``SCRATCH`` from ``workloads/generate.py``, so the checker imports
``torch``. The reference's ``tools.tpumc`` and its
``gpushare_device_plugin_tpu.*`` modules in ``sys.modules`` stay as they
were, so the reference's own checker tests in the same process still check
the reference.

:func:`reference_untouched` is the guard around a run: it fails if the
run imported any ``gpushare_device_plugin_tpu`` module, even one already
loaded, on the calling thread or a model thread.

``load_test(name)`` executes ``tests/<name>.py``, a reference test of the
checker, with ``tools.tpumc`` pointed at that package and the reference
package at the port, so its own assertions hold the port.

:class:`BindRaceModel` is a model the reference's suite lacks: the
extender's bind decision racing the watch (``ROADMAP.md`` §3 fault 9). It
runs over either package under that package's checker.

``python tests/torch_mc_mirror.py port|reference MODEL...`` explores each
named model (of the smoke suite at the suite's bound, or of
:data:`EXTENSIONS`) over one package and prints one JSON line a model (its
schedules, truncation, violations and, over the port, the reference
modules loaded: none). The port's side never imports the reference; the
reference's side runs ``tools.tpumc`` itself.

A violation found on the port replays by its schedule id::

    from torch_mc_mirror import load
    mc = load()
    out = mc.explore.Explorer(mc.models.get_model("gang2pc"), k=2).replay(sid)
    print(out.violation, out.trace)

(run from ``tests/`` or with it on ``sys.path``).
"""

from __future__ import annotations

import builtins
import contextlib
import importlib.util
import json
import re
import sys
import threading
import types
from pathlib import Path
from typing import Iterator

REF = "gpushare_device_plugin_tpu"
PORT = "gpushare_device_plugin_tpu_torch"
TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
TOOLS = ROOT / "tools" / "tpumc"
NAME = "_tpumc_on_torch"
MODULES = ("sched", "explore", "memwal", "models")  # in import order

_REF_NAME = re.compile(rf"\b{REF}\b")
_TOOLS_NAME = re.compile(r"\btools\.tpumc\b")
_TESTS: dict[str, types.ModuleType] = {}


def _is_ref(module: str) -> bool:
    return module == REF or module.startswith(REF + ".")


def load() -> types.ModuleType:
    """The checker's package with its imports on the port (made once)."""
    pkg = sys.modules.get(NAME)
    if pkg is not None:
        return pkg
    pkg = types.ModuleType(NAME)
    pkg.__path__ = []
    pkg.__package__ = NAME
    sys.modules[NAME] = pkg
    try:
        with reference_untouched():
            for name in MODULES:
                path = TOOLS / f"{name}.py"
                mod = types.ModuleType(f"{NAME}.{name}")
                mod.__file__ = str(path)
                mod.__package__ = NAME
                sys.modules[mod.__name__] = mod
                src = _REF_NAME.sub(PORT, path.read_text())
                exec(compile(src, str(path), "exec"), mod.__dict__)
                setattr(pkg, name, mod)
    except BaseException:
        for key in [k for k in sys.modules if k == NAME or k.startswith(NAME + ".")]:
            del sys.modules[key]
        raise
    return pkg


@contextlib.contextmanager
def reference_untouched() -> Iterator[list[str]]:
    """Fail if the block imports a reference module: a new entry in
    ``sys.modules``, or any import statement (a cached module included)
    run on this thread or on a model thread (``tpumc-*``)."""
    before = {k for k in sys.modules if _is_ref(k)}
    caller = threading.current_thread()
    seen: list[str] = []
    real = builtins.__import__

    def guarded(name, globals=None, locals=None, fromlist=(), level=0):
        if level:
            package = (globals or {}).get("__package__") or ""
            full = importlib.util.resolve_name("." * level + name, package)
        else:
            full = name
        if _is_ref(full):
            thread = threading.current_thread()
            if thread is caller or thread.name.startswith("tpumc-"):
                seen.append(full)
        return real(name, globals, locals, fromlist, level)

    builtins.__import__ = guarded
    try:
        yield seen
    finally:
        builtins.__import__ = real
    new = sorted({k for k in sys.modules if _is_ref(k)} - before)
    assert not seen and not new, (
        f"the checker reached the reference package: imported {sorted(set(seen))}, "
        f"newly loaded {new}")


def load_test(test_file: str) -> types.ModuleType:
    """``tests/<test_file>.py`` executed over the port's checker package."""
    if test_file in _TESTS:
        return _TESTS[test_file]
    load()
    path = TESTS / f"{test_file}.py"
    src = _TOOLS_NAME.sub(NAME, _REF_NAME.sub(PORT, path.read_text()))
    mod = types.ModuleType(f"{NAME}_{test_file}")
    mod.__file__ = str(path)
    with reference_untouched():
        exec(compile(src, str(path), "exec"), mod.__dict__)
    _TESTS[test_file] = mod
    return mod


class BindRaceModel:
    """One model the reference's suite lacks, over either package: the
    scheduler extender's bind decision (``ExtenderCore.bind`` over its
    ``PodInformer`` and usage index) racing the watch, where ``ROADMAP.md``
    §3 fault 9 lives. The smoke models do not reach it: their shards run
    without an informer, so every view comes from a LIST.

    One node of one 8-unit chip; pods ``first`` and ``second`` of 8 units,
    pending and in the synced cache. Three tasks: ``bind-first`` and
    ``bind-second`` bind their pod to the node; ``watch`` waits until the
    bind of ``first`` has ended and feeds the apiserver's copy of it to the
    informer (the watch event). The invariant is the gang models': no chip
    over capacity at the end. ``checker`` is the ``tools.tpumc`` package the
    model runs under (the reference's own, or :func:`load`'s)."""

    def __init__(self, checker: types.ModuleType, package: str) -> None:
        self.name = "extender-bind-race"
        self.checker = checker
        self.package = package

    def build(self):
        def mod(name: str) -> types.ModuleType:
            return importlib.import_module(f"{self.package}.{name}")

        models, sched = self.checker.models, self.checker.sched
        P, simcluster = mod("cluster.pods"), mod("extender.simcluster")
        landed = sched.active_scheduler().factory().event("model.watch")

        class WatchedApi(models.ModelApi):
            """The model apiserver with resourceVersions, which the
            informer orders events by, and a LIST that returns one."""

            def __init__(self) -> None:
                super().__init__()
                self.rv = 1

            def _stamp(self, ns: str, name: str) -> None:
                self.rv += 1
                self.pods[(ns, name)]["metadata"]["resourceVersion"] = str(self.rv)

            def add_pod(self, pod: dict) -> None:
                super().add_pod(pod)
                self._stamp(P.namespace(pod), P.name(pod))

            def patch_pod(self, ns: str, name: str, patch: dict) -> dict:
                super().patch_pod(ns, name, patch)
                self._stamp(ns, name)
                return self.get_pod(ns, name)

            def bind_pod(self, ns: str, name: str, node: str) -> None:
                super().bind_pod(ns, name, node)
                self._stamp(ns, name)

            def list_pods_with_rv(self, **_kw) -> tuple[list[dict], str]:
                return self.list_pods(), str(self.rv)

        api = WatchedApi()
        api.add_node(simcluster.synth_node("n1", "1", 1, 8))
        for name in ("first", "second"):
            api.add_pod(models._pod(name, 8))
        informer = mod("cluster.informer").PodInformer(api)
        core = mod("extender.server").ExtenderCore(api, informer=informer)
        informer.refresh()  # the authoritative LIST: synced, both pending
        results: dict[str, dict] = {}

        def bind(name: str):
            def body() -> None:
                try:
                    results[name] = core.bind(
                        {"podName": name, "podNamespace": "default", "node": "n1"})
                finally:
                    if name == "first":
                        landed.set()
            return body

        def watch() -> None:
            landed.wait()
            informer.note_pod_update(api.get_pod("default", "first"))

        def check() -> None:
            used: dict[int, int] = {}
            for pod in api.pods.values():
                idx = P.chip_idx_from_annotation(pod)
                if P.node_name(pod) == "n1" and idx >= 0:
                    used[idx] = used.get(idx, 0) + P.mem_units_of_pod(pod)
            for chip, units in used.items():
                if units > 8:
                    raise sched.InvariantViolation(
                        f"chip n1/{chip} overcommitted: {units} > 8 (binds: {results})")

        return models.Harness(
            [("bind-first", bind("first")), ("watch", watch), ("bind-second", bind("second"))],
            check)


# models the reference's suite lacks, with their bound
EXTENSIONS = {"extender-bind-race": (BindRaceModel, 2)}


def checker_for(package: str) -> tuple[types.ModuleType, str]:
    """The checker package over ``package`` ("port" or "reference") and
    the package's name."""
    if package == "port":
        return load(), PORT
    for name in MODULES:  # the reference's own checker, as its package
        importlib.import_module(f"tools.tpumc.{name}")
    return sys.modules["tools.tpumc"], REF


def explore_smoke(package: str, names: list[str]) -> Iterator[dict]:
    """Each named model (of the smoke suite, at its bound, or of
    :data:`EXTENSIONS`) explored over ``package`` ("port" or
    "reference"), as a JSON-safe record."""
    checker, pkg = checker_for(package)
    guard = reference_untouched if package == "port" else contextlib.nullcontext
    bounds = dict(checker.models.SMOKE_SUITE)
    for name in names:
        if name in EXTENSIONS:
            make, k = EXTENSIONS[name]
            model = make(checker, pkg)
        else:
            k, model = bounds[name], checker.models.get_model(name)
        with guard():
            result = checker.explore.Explorer(model, k=k).explore()
        yield {
            "package": package, "model": name, "k": k,
            "schedules": result.schedules, "truncated": result.truncated,
            "wall_s": result.wall_s, "summary": result.summary(),
            "violations": [{"schedule_id": v.schedule_id, "kind": v.kind,
                            "message": v.message[:2000]} for v in result.violations[:5]],
            "n_violations": len(result.violations),
            "reference_modules": sorted(k for k in sys.modules if _is_ref(k)),
        }


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    for record in explore_smoke(sys.argv[1], sys.argv[2:]):
        print(json.dumps(record), flush=True)
