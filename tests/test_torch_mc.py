"""The port's concurrency discipline, held by the reference's own tools.

- The reference's model checker (``tools/tpumc``) runs unedited over the
  port's journaled protocols through ``torch_mc_mirror``: every ``(model,
  k)`` of its ``SMOKE_SUITE`` (the drain handshake, the gang 2PC and its
  live resolve, the defrag move, the KV handoff, the fleet scale-down, with
  their crash variants), one case each, with zero violations and no
  truncation, and the reference's floors on the port alone (combined and
  handoff models each over 1,000 schedules, ``tests/test_mc_smoke.py``).
  Each case prints both packages' schedule counts: the smoke explorations
  run in child processes (each package's gang2pc, each package's other
  models, and the port's bind race below) started when this module's first
  test starts, so they run beside the tests that follow. The port's
  children never import the reference.
- A model the reference's suite lacks, ``torch_mc_mirror.BindRaceModel``:
  the extender's bind decision racing the watch over its informer and
  usage index. Over the reference it finds ``ROADMAP.md`` §3 fault 9 (a
  chip double-booked) at one preemption, and the schedule replays; over
  the port, which repairs it, it finds nothing at two.
- The reference's checker tests that build a port class
  (``tests/test_tpumc.py``: the seeded drain, gang and move defects, the
  live-resolve rollback, replay by schedule id, the bound's monotonicity,
  POR on the drain model) and the smoke suite's shape test run over the
  port, each under the guard that no reference module is imported.
- The witness: ``tests/test_lockwitness.py``'s cases on the port's
  ``lockrank``; both ``RANKS`` tables equal; the seam names are what
  ``mc_session`` drives; both packages fire the same fault points; and a
  serving engine moved by the ``SliceMover`` (phase 24 of ``chip_smoke.py``
  at test size, on the CPU) takes its locks in rank order, the drain
  handshake's and the radix cache's among them.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from gpushare_device_plugin_tpu.utils import lockrank as JL
from gpushare_device_plugin_tpu_torch.allocator import defrag as TD
from gpushare_device_plugin_tpu_torch.allocator.assume import AssumeCache
from gpushare_device_plugin_tpu_torch.allocator.checkpoint import (
    AllocationCheckpoint,
    replay_checkpoint,
)
from gpushare_device_plugin_tpu_torch.cluster.apiserver import ApiServerClient
from gpushare_device_plugin_tpu_torch.cluster.podsource import ApiServerPodSource
from gpushare_device_plugin_tpu_torch.cluster.reconciler import DriftReconciler
from gpushare_device_plugin_tpu_torch.serving import engine as TE
from gpushare_device_plugin_tpu_torch.utils import lockrank as TL
from gpushare_device_plugin_tpu_torch.utils.faults import FAULTS, SimulatedCrash
from gpushare_device_plugin_tpu_torch.workloads import transformer as T

from fake_apiserver import FakeApiServer
from k8s_fixtures import assigned_running_pod
from torch_cluster_mirror import run_case
from torch_mc_mirror import (
    EXTENSIONS,
    PORT,
    REF,
    ROOT,
    BindRaceModel,
    checker_for,
    load,
    load_test,
    reference_untouched,
)

MC = load()
SMOKE = MC.models.SMOKE_SUITE
MIN_COMBINED_SCHEDULES = 1_000  # tests/test_mc_smoke.py's floor
# the smoke explorations, one child process a group: gang2pc is the longest;
# and the port's bind race at its bound
GROUPS = [(pkg, names) for pkg in ("port", "reference")
          for names in (["gang2pc"], [m for m, _ in SMOKE if m != "gang2pc"])]
GROUPS.append(("port", ["extender-bind-race"]))
WITNESS_CASES = re.findall(r"^def (test_\w+)", (ROOT / "tests" / "test_lockwitness.py").read_text(),
                           re.M)
# tests/test_tpumc.py's tests that build a port class (the rest hold the
# explorer itself on toy models)
TPUMC_CASES = [
    "test_same_schedule_id_replays_byte_identical_trace",
    "test_bound_monotonicity_violations_found_at_k_survive_k_plus_1",
    "test_por_keeps_clean_models_clean",
    "test_checker_finds_seeded_drain_lost_capture_bug",
    "test_checker_finds_move_overcommit_when_revalidation_disabled",
    "test_live_resolve_rollback_defect_found_pinned_and_fixed",
    "test_checker_finds_gang_overcommit_when_prepare_check_disabled",
]


class SmokeRuns:
    """The smoke explorations of :data:`GROUPS`, one child each, started
    together; :meth:`result` waits for the child that runs a model."""

    def __init__(self, tmp: Path) -> None:
        self.procs = []
        for i, (pkg, names) in enumerate(GROUPS):
            out, err = tmp / f"{i}.out", tmp / f"{i}.err"
            with open(out, "w") as fo, open(err, "w") as fe:
                proc = subprocess.Popen(
                    [sys.executable, str(ROOT / "tests" / "torch_mc_mirror.py"), pkg, *names],
                    cwd=ROOT, stdout=fo, stderr=fe, env={**os.environ, "JAX_PLATFORMS": "cpu"})
            self.procs.append((pkg, names, proc, out, err))
        self.records: dict[tuple[str, str], dict] = {}

    def result(self, pkg: str, model: str) -> dict:
        for p, names, proc, out, err in self.procs:
            if p != pkg or model not in names:
                continue
            rc = proc.wait(timeout=600)
            for line in out.read_text().splitlines():
                rec = json.loads(line)
                self.records[(rec["package"], rec["model"])] = rec
            assert (pkg, model) in self.records, (
                f"the {pkg} child exited {rc} without {model}:\n{err.read_text()[-4000:]}")
            return self.records[(pkg, model)]
        raise KeyError((pkg, model))

    def stop(self) -> None:
        for *_, proc, _out, _err in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def smoke(tmp_path_factory):
    runs = SmokeRuns(tmp_path_factory.mktemp("mc_smoke"))
    yield runs
    runs.stop()


# --- the reference's checker tests, over the port -------------------------------


@pytest.mark.parametrize("name", TPUMC_CASES)
def test_reference_checker_tests_hold_the_port(name):
    mod = load_test("test_tpumc")
    with reference_untouched():
        getattr(mod, name)()


def test_smoke_suite_shape_on_the_port():
    with reference_untouched():
        load_test("test_mc_smoke").test_smoke_suite_shape_documents_bounds()


# --- the seam ---------------------------------------------------------------------


class _SeamModel:
    """One task that takes the port's ranked lock, waits on its event after
    setting it, and fires a WAL point: each is a yield of the mirror's
    scheduler."""

    name = "seam"

    def build(self):
        lock = TL.make_lock("serving.drain")
        evt = TL.make_event("serving.drain.request")

        def task():
            with lock:
                evt.set()
            evt.wait()
            FAULTS.fire("checkpoint.begin")

        return MC.models.Harness([("t", task)], lambda: None)


def test_the_seam_is_what_mc_session_drives():
    sched = MC.sched
    with reference_untouched():
        with sched.mc_session(sched.MCScheduler(lambda s, enabled: enabled[0])):
            assert TL.mc_active() and not JL.mc_active()
            assert isinstance(TL.make_lock("serving.radix"), sched.MCLock)
            assert TL.make_rlock("checkpoint.journal").reentrant
            assert isinstance(TL.make_condition("wal.batcher"), sched.MCCondition)
            assert isinstance(TL.make_event("serving.drain.drained"), sched.MCEvent)
            with pytest.raises(ValueError, match="declared rlock"):
                TL.make_lock("allocator.ledger")  # the rank check comes first
        assert not TL.mc_active()
        assert isinstance(TL.make_lock("serving.drain"), type(threading.Lock()))
        assert isinstance(TL.make_event("serving.drain.request"), threading.Event)
        trace = MC.explore.Explorer(_SeamModel(), k=0).run_one([], collect_trace=True).trace
    assert trace.splitlines() == [
        "0 start t", "0 acquire serving.drain", "0 evt_set serving.drain.request",
        "0 release serving.drain", "0 evt_wait serving.drain.request",
        "0 fire checkpoint.begin"]
    assert [r.name for r in TL.ordered(["metrics.registry", "allocator.serial"])] == [
        "allocator.serial", "metrics.registry"]


def _fired(pkg: str) -> set[str]:
    names = set()
    for path in (ROOT / pkg).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fire" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "FAULTS" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                names.add(node.args[0].value)
    return names


def test_both_packages_fire_the_same_points():
    """Every ``FAULTS.fire`` site is a yield point of the checker: the port
    fires each of the reference's, under the same name, the WAL's
    ``checkpoint.begin/commit/abort`` included."""
    port = _fired(PORT)
    assert port == _fired(REF)
    assert {"checkpoint.begin", "checkpoint.commit", "checkpoint.abort"} <= port
    assert len(port) > 30


# --- the witness ------------------------------------------------------------------


def test_both_rank_tables_are_equal():
    """Every lock the reference ranks, ranked alike in the port: name,
    rank, kind, I/O rule and reason."""
    assert list(TL.RANKS) == list(JL.RANKS)
    for name, rank in JL.RANKS.items():
        assert dataclasses.astuple(TL.RANKS[name]) == dataclasses.astuple(rank), name


@pytest.mark.parametrize("name", WITNESS_CASES)
def test_reference_witness_tests_hold_the_port(name, tmp_path_factory):
    run_case(PORT, "test_lockwitness", name, {}, tmp_path_factory)
    assert TL.violations() == []


SHAPE = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=64)
ENGINE = dict(slots=2, max_len=32, total_pages=24, page_size=4, prefill_chunk=4, eos_id=3)
NODE = "mc-node"


def test_a_move_of_a_serving_engine_takes_its_locks_in_rank_order(tmp_path):
    """``chip_smoke.py``'s phase 24 at test size: under the witness, a
    source engine serving on a thread is drained by a ``SliceMover`` (real
    WAL, ``AssumeCache`` and PATCHes), once clean and once crashed past the
    switch and rolled forward by a fresh reconciler; the destination
    restores. The serving thread waits at its third tick's boundary until
    the mover has asked for the drain, so each drain lands mid-run. No
    inversion, and the drain handshake's and the radix cache's locks are
    among those taken."""
    cfg = T.TransformerConfig(**SHAPE, compute_dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trace = TE.poisson_trace(8, seed=11, rate=0.3, vocab=SHAPE["vocab"], prompt_lens=(1, 9),
                             max_new=(2, 10))
    TL.set_witness(True)
    TL.reset_violations()
    api = FakeApiServer()
    api.add_node(NODE)
    api.start()
    try:
        src = TE.PagedSlotEngine(params, cfg, device="cpu", **ENGINE)
        dst = TE.PagedSlotEngine(params, cfg, device="cpu", **ENGINE)
        want = {r.rid: list(r.tokens) for r in src.run(trace).results}
        handshake = src._drain
        armed = handshake.armed
        for i, site in enumerate((None, "defrag.switch")):
            api.add_pod(assigned_running_pod(f"p{i}", 2, chip_idx=0, node=NODE))
            got: dict = {}
            requested = threading.Event()

            def held_armed() -> bool:
                if src.ticks >= 3:
                    requested.wait(timeout=60)
                return armed()

            def drain(key):
                src.request_drain()
                requested.set()
                return src.wait_drained(timeout=60)

            def restore(key, snap):
                got.update({r.rid: list(r.tokens) for r in dst.restore_snapshot(snap).results})

            wal = str(tmp_path / f"wal-{i}")
            client = ApiServerClient(api.url)
            source = ApiServerPodSource(client, NODE)
            ckpt = AllocationCheckpoint(wal)
            mover = TD.SliceMover(client, source, AssumeCache(), ckpt, NODE,
                                  lambda: {0: 32, 1: 32}, drain_fn=drain, restore_fn=restore)
            served: dict = {}
            handshake.armed = held_armed
            serving = threading.Thread(target=lambda: served.update(run=src.run(trace)),
                                       name="serving")
            serving.start()
            plan = TD.MovePlan(pod=("default", f"p{i}"), src=0, dst=1, units=2)
            if site is None:
                assert mover.execute(plan)
            else:
                with FAULTS.injected(site, "crash", times=1), pytest.raises(SimulatedCrash):
                    mover.execute(plan)
                ckpt.abandon()
                ckpt, assume = AllocationCheckpoint(wal), AssumeCache()
                replay_checkpoint(ckpt, assume)
                assert DriftReconciler(api=client, pod_source=source, assume=assume,
                                       checkpoint=ckpt, node_name=NODE,
                                       move_restore_fn=restore).reconcile_once() == {
                    "move_rollforward": 1}
            serving.join(timeout=60)
            del handshake.armed
            ckpt.close()
            assert not serving.is_alive()
            assert got, f"move {i}: nothing was drained mid-run"
            assert {r.rid: list(r.tokens) for r in served["run"].results} | got == want
        ranks = TL.acquired_ranks()
        TL.assert_clean("a move of a serving engine")
    finally:
        api.stop()
        TL.set_witness(None)
        TL.reset_violations()
    assert {"serving.drain", "serving.radix", "serving.pages", "defrag.moves",
            "checkpoint.journal", "allocator.ledger"} <= set(ranks), ranks


# --- the smoke gate over the port -------------------------------------------------


@pytest.mark.parametrize("model,k", SMOKE, ids=[f"{m}-k{k}" for m, k in SMOKE])
def test_smoke_suite_over_the_port(model, k, smoke):
    port = smoke.result("port", model)
    ref = smoke.result("reference", model)
    print(f"\n{model} (k={k}): port {port['schedules']} schedules, reference "
          f"{ref['schedules']}\n  port: {port['summary']}\n  reference: {ref['summary']}")
    assert port["k"] == k and port["reference_modules"] == []
    assert not port["truncated"], f"{model}: exploration truncated"
    assert port["n_violations"] == 0, (
        f"{model}: {port['n_violations']} violating schedule(s) on the port:\n" + "\n".join(
            f"  [{v['kind']}] {v['schedule_id']}: {v['message']}" for v in port["violations"]))


def test_smoke_floors_on_the_port_alone(smoke):
    counts = {m: smoke.result("port", m)["schedules"] for m, _ in SMOKE}
    ref = {m: smoke.result("reference", m)["schedules"] for m, _ in SMOKE}
    total = sum(counts.values())
    handoff = sum(n for m, n in counts.items() if m.startswith("handoff"))
    print(f"\ncombined: port {total} schedules, reference {sum(ref.values())}; "
          f"handoff models: port {handoff}")
    assert total > MIN_COMBINED_SCHEDULES, counts
    assert handoff > MIN_COMBINED_SCHEDULES, counts


def test_bind_race_finds_fault_9_in_the_reference_and_not_in_the_port(smoke):
    port = smoke.result("port", "extender-bind-race")
    assert port["k"] == EXTENSIONS["extender-bind-race"][1] == 2
    assert port["reference_modules"] == [] and not port["truncated"]
    assert port["n_violations"] == 0, port["violations"]
    checker, pkg = checker_for("reference")
    ref = checker.explore.Explorer(BindRaceModel(checker, pkg), k=1)
    found = ref.explore()
    over = [v for v in found.violations if "overcommitted" in v.message]
    print(f"\nextender-bind-race: port {port['schedules']} schedules at k=2, 0 violations; "
          f"reference {found.schedules} at k=1, {len(over)} overcommitting")
    assert over, [v.brief() for v in found.violations]
    assert len(over) == len(found.violations)
    replayed = ref.replay(over[0].schedule_id)
    assert replayed.trace == over[0].trace and "overcommitted" in replayed.violation.message
