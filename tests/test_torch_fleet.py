"""The port's fleet protocol (gpushare_device_plugin_tpu_torch:
``serving/router.py``, ``extender/policy.py``, ``utils/decisions.py`` and
the radix fingerprints) against the reference's, with no engine.

Every case runs on both sides and the port's answer must equal the
reference's exactly: fingerprints, policy scores and rankings, membership
eviction and recovery, route decisions (engine, outcome, reason, affinity
pages), the emitted decision records (all but their wall time), the
``tpushare_router_*`` / ``tpushare_fleet_*`` samples, and the journaled
scale-down: a kill at each ``scale.*`` journal boundary through each
side's ``FAULTS``, resolved from the WAL alone by that side's
``resolve_scale`` (roll forward at or past ``migrate``, back before it,
every request served exactly once), with byte-identical WAL files. A
scale entry journaled by one package resolves under the other's
``resolve_scale``. Each side has its own ``DecisionLog`` and
``MetricsRegistry``, so no process-global ring mixes the two.
"""

import types

import numpy as np
import pytest

from gpushare_device_plugin_tpu.allocator import assume as JA
from gpushare_device_plugin_tpu.allocator import checkpoint as JC
from gpushare_device_plugin_tpu.extender import policy as JPol
from gpushare_device_plugin_tpu.serving import pages as JPg
from gpushare_device_plugin_tpu.serving import radix as JRad
from gpushare_device_plugin_tpu.serving import router as JR
from gpushare_device_plugin_tpu.utils import decisions as JD
from gpushare_device_plugin_tpu.utils import faults as JF
from gpushare_device_plugin_tpu.utils import metrics as JM
from gpushare_device_plugin_tpu.utils import slo as JS
from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.allocator import assume as TA
from gpushare_device_plugin_tpu_torch.allocator import checkpoint as TC
from gpushare_device_plugin_tpu_torch.extender import policy as TPol
from gpushare_device_plugin_tpu_torch.serving import pages as TPg
from gpushare_device_plugin_tpu_torch.serving import radix as TRad
from gpushare_device_plugin_tpu_torch.serving import router as TR
from gpushare_device_plugin_tpu_torch.utils import decisions as TD
from gpushare_device_plugin_tpu_torch.utils import faults as TF
from gpushare_device_plugin_tpu_torch.utils import lockrank
from gpushare_device_plugin_tpu_torch.utils import metrics as TM
from gpushare_device_plugin_tpu_torch.utils import slo as TS

NODE = "node-fleet"
SIDES = {
    "ref": types.SimpleNamespace(A=JA, C=JC, Pol=JPol, Pg=JPg, Rad=JRad, R=JR, D=JD, F=JF, M=JM,
                                 S=JS),
    "port": types.SimpleNamespace(A=TA, C=TC, Pol=TPol, Pg=TPg, Rad=TRad, R=TR, D=TD, F=TF, M=TM,
                                  S=TS),
}
# Every boundary the scale-down journal defines, in protocol order; None is
# the uncrashed run. ``migrate`` is the commit point.
SITES = [None, "scale.cordon", "scale.drain", "scale.migrate", "scale.release"]


@pytest.fixture(autouse=True)
def _clean_faults():
    JF.FAULTS.clear()
    TF.FAULTS.clear()
    yield
    JF.FAULTS.clear()
    TF.FAULTS.clear()


def both(scenario):
    """``scenario(side)`` on the reference and on the port; the port's
    result must equal the reference's. Returns it."""
    want, got = scenario(SIDES["ref"]), scenario(SIDES["port"])
    assert got == want
    return got


def records(log):
    """A decision log's records as dicts, without their wall time."""
    return [{k: v for k, v in r.to_dict().items() if k != "time_unix"} for r in log.records()]


def fleet_samples(reg):
    """The router's and the fleet's lines of a registry's exposition."""
    return [line for line in reg.render().splitlines()
            if "tpushare_router_" in line or "tpushare_fleet_" in line]


# --- fingerprints -------------------------------------------------------------


@pytest.mark.parametrize("page_size", [1, 3, 4, 16])
def test_prefix_fingerprints_equal_the_references(page_size):
    rng = np.random.RandomState(page_size)
    prompts = [tuple(int(t) for t in rng.randint(-2**31, 2**31 - 1, n))
               for n in (0, 1, page_size - 1, page_size, 5 * page_size + 2, 64)]
    prompts.append(prompts[-1][:32] + (7,) * 40)  # shares a prefix with the last one
    got = both(lambda s: [s.Rad.prefix_fingerprints(p, page_size) for p in prompts])
    # a chained value commits to its whole path: a shared first page
    # agrees, the first differing page and every one after it do not
    a, b = got[-2], got[-1]
    shared = 32 // page_size
    assert a[:shared] == b[:shared] and all(x != y for x, y in zip(a[shared:], b[shared:]))
    with pytest.raises(ValueError):
        TRad.prefix_fingerprints((1, 2), 0)


def test_radix_fingerprints_are_the_union_over_adapter_trees():
    """The reference keeps one tree keyed by tokens; the port keeps one per
    adapter. After the same inserts (the port's under two adapters and the
    base model, one prompt under two of them) the port's sorted union is
    the reference's list, each path once."""
    ps = 4
    rng = np.random.RandomState(11)
    sys_prompt = tuple(int(t) for t in rng.randint(0, 1000, 12))
    prompts = [(sys_prompt + tuple(int(t) for t in rng.randint(0, 1000, n)), aid)
               for n, aid in ((9, ""), (4, "t0"), (13, "t1"), (3, "t0"))]
    prompts.append((prompts[1][0], "t1"))  # t0's prompt again under t1
    jalloc, talloc = JPg.PageAllocator(128), TPg.PageAllocator(128)
    jrad, trad = JRad.RadixCache(ps, jalloc), TRad.RadixCache(ps, talloc)
    for tokens, aid in prompts:
        n = len(tokens) // ps
        jrad.insert(tokens, jalloc.alloc(n))
        trad.insert(tokens, talloc.alloc(n), adapter_id=aid)
    got = trad.fingerprints()
    assert got == jrad.fingerprints() == sorted(set(got))
    assert trad.cached_pages > jrad.cached_pages == len(got)
    expected = set()
    for tokens, _ in prompts:
        expected.update(TRad.prefix_fingerprints(tokens, ps))
    assert set(got) == expected
    assert TRad.RadixCache(ps, TPg.PageAllocator(4)).fingerprints() == []


# --- policies ----------------------------------------------------------------


def _views(pol_mod, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(40):
        cap = int(rng.randint(0, 9))
        free = int(rng.randint(0, cap + 2))
        gang = rng.rand() < 0.3
        out.append(pol_mod.PolicyView(
            free_units=free, capacity=cap, request_units=int(rng.randint(1, 3)),
            free_vector=tuple(int(x) for x in rng.randint(0, cap + 1, rng.randint(0, 4))),
            chip=int(rng.randint(0, 4)) if rng.rand() < 0.5 else None,
            ici_hops=int(rng.randint(0, 4)) if gang else None,
            stranded=int(rng.randint(0, 3)) if gang else None,
            broken=int(rng.randint(0, 2)) if gang else None,
            tie_break=int(rng.randint(0, 3)) if rng.rand() < 0.2 else None,
            affinity_pages=int(rng.randint(0, 12)) if rng.rand() < 0.7 else None,
        ))
    return out


@pytest.mark.parametrize("name", sorted(JPol.policy_names()))
def test_every_policy_scores_and_ranks_as_the_reference(name):
    assert TPol.policy_names() == JPol.policy_names()

    def scenario(s):
        pol = s.Pol.resolve(name)
        scores = {f"n{i}": pol.score(v) for i, v in enumerate(_views(s.Pol, 5))}
        return (pol.name, pol.chip_policy,
                {n: (sv.to_dict(), sv.raw) for n, sv in scores.items()},
                s.D.rank_scores(scores))

    both(scenario)


def test_prefix_affinity_saturated_warm_beats_roomy_cold():
    pol = TPol.resolve("prefix-affinity")
    warm = pol.score(TPol.PolicyView(free_units=1, capacity=4, request_units=1,
                                     affinity_pages=8))
    cold = pol.score(TPol.PolicyView(free_units=3, capacity=4, request_units=1,
                                     affinity_pages=0))
    full = pol.score(TPol.PolicyView(free_units=0, capacity=4, request_units=1,
                                     affinity_pages=8))
    assert warm.raw > cold.raw and full.raw <= 0.0
    with pytest.raises(KeyError):
        TPol.get_policy("no-such-policy")


def test_decision_log_rings_and_segments_as_the_reference(tmp_path):
    def scenario(s):
        seg = tmp_path / s.D.__name__ / "decisions.jsonl"
        log = s.D.DecisionLog(max_records=3, segment_path=str(seg), segment_max_bytes=600)
        for i in range(5):
            log.emit(f"r{i}", "fleet_route", node="e0", reason="why", candidates=2,
                     scores={"e0": s.D.chip_breakdown(3, 4, None, 1, "spread")})
        log.configure(enabled=False)
        off = log.emit("r9", "fleet_shed")
        log.close()
        rotated = (seg.parent / (seg.name + ".1")).exists()
        return (records(log), log.dropped(), log.size(), off, rotated,
                log.to_doc(verb="fleet_route", limit=2)["max_records"])

    got = both(scenario)
    assert got[1] == 2 and got[4]


# --- membership ---------------------------------------------------------------


def _flaky_client(s, fail):
    def scrape():
        if fail["down"]:
            raise RuntimeError("replica unreachable")
        return {"free_slots": 2, "capacity": 2, "queue_depth": fail.get("q", 0),
                "fingerprints": [11, 22]}

    return s.R.EngineScrapeClient(scrape, attempts=1, sleep=lambda _: None, clock=lambda: 0.0)


def test_membership_evicts_after_consecutive_misses_and_resets_on_recovery():
    def scenario(s):
        reg = s.M.MetricsRegistry()
        fail = {"down": False}
        mem = s.R.FleetMembership(miss_threshold=2, registry=reg, pod="ns/fleet")
        mem.add("e0", _flaky_client(s, fail), capacity=2)
        flappy = {"down": True, "q": 3}
        mem.add("e1", _flaky_client(s, flappy), capacity=2, free_slots=1)
        mem.add("e2", None, capacity=4)
        steps = []
        for down, fdown in ((False, True), (True, False), (True, True), (True, False)):
            fail["down"], flappy["down"] = down, fdown
            steps.append((mem.scrape_once(), mem.doc()))
            mem.publish()
        mem.note_routed("e2", [5, 6])
        view = [(m.name, m.state, sorted(m.fingerprints), m.free_slots, m.capacity,
                 m.queue_depth) for m in mem.snapshot()]
        return steps, view, mem.names(), fleet_samples(reg)

    steps, view, names, _ = both(scenario)
    assert steps[1][1]["replicas"]["e0"] == {
        "state": "ready", "misses": 1, "free_slots": 2, "capacity": 2, "queue_depth": 0,
        "fingerprints": 2}
    assert steps[2][1]["replicas"]["e0"]["state"] == "dead"
    assert "e0" not in steps[3][0]  # the dead are not scraped again
    # e1 missed, recovered (the count resets), missed again: still ready
    assert [st[1]["replicas"]["e1"]["misses"] for st in steps] == [1, 0, 1, 0]
    assert steps[2][1]["replicas"]["e1"]["state"] == "ready"
    assert view[2][2] == [5, 6] and names == ["e0", "e1", "e2"]
    with pytest.raises(ValueError):
        TR.FleetMembership(miss_threshold=0)
    mem = TR.FleetMembership()
    with pytest.raises(ValueError):
        mem.set_state("e0", "asleep")


# --- routes -------------------------------------------------------------------


def _router(s, caps, **kw):
    reg, log = s.M.MetricsRegistry(), s.D.DecisionLog()
    mem = s.R.FleetMembership(registry=reg)
    for name, cap in caps.items():
        mem.add(name, None, capacity=cap)
    return mem, s.R.FleetRouter(mem, page_size=4, decisions=log, registry=reg, pod="ns/fleet",
                                **kw), log, reg


def _decided(d):
    return (d.rid, d.engine, d.outcome, d.reason, d.affinity_pages, d.shed)


def _stickiness(s):
    mem, router, log, reg = _router(s, {"a": 4, "b": 4})
    prompt = (5, 6, 7, 8, 9, 10, 11, 12)
    out = [_decided(router.route("1", prompt)), _decided(router.route("2", prompt)),
           _decided(router.route("3", prompt[:4] + (1, 1, 1, 1)))]
    return out, router.doc(), records(log), fleet_samples(reg)


def _overflow(s):
    mem, router, log, reg = _router(s, {"a": 0, "b": 0})
    out = [_decided(router.route(str(i), (1, 2, 3, 4))) for i in range(3)]
    return out, router.doc(), router.least_loaded(), records(log), fleet_samples(reg)


def _no_replicas(s):
    mem, router, log, reg = _router(s, {"a": 4})
    mem.cordon("a")
    out = [_decided(router.route("1", (1, 2, 3, 4)))]
    mem.uncordon("a")
    out.append(_decided(router.route("2", (1, 2, 3, 4))))
    mem.mark_dead("a")
    out.append(_decided(router.route("3", (1, 2, 3, 4))))
    return out, router.doc(), router.least_loaded(), records(log), fleet_samples(reg)


def _shed_on_page(s):
    clock = {"t": 1000.0}
    budget = s.S.SloBudget(clock=lambda: clock["t"])
    for _ in range(50):
        budget.record("critical", False)
    mem, router, log, reg = _router(s, {"a": 4}, slo_budget=budget)
    out = [_decided(router.route("1", (1, 2, 3, 4), tier="best_effort")),
           _decided(router.route("2", (1, 2, 3, 4), tier="critical"))]
    return budget.severity("critical"), out, router.doc(), records(log), fleet_samples(reg)


def _shed_on_queue_depth(s):
    mem, router, log, reg = _router(s, {"a": 1}, shed_queue_depth=1)
    out = [_decided(router.route("1", (1, 2, 3, 4), tier="critical")),
           _decided(router.route("2", (1, 2, 3, 4), tier="best_effort")),
           _decided(router.route("3", (1, 2, 3, 4), tier="critical"))]
    return out, router.doc(), records(log), fleet_samples(reg)


def _restart_seeding(s):
    mem, router, log, reg = _router(s, {"a": 4, "b": 4})
    router.route("1", (1, 2, 3, 4))
    _, router2, log2, _ = _router(s, {"a": 4, "b": 4})
    router2.seed_inflight({"1": "a", "7": "b"})
    router2.seed_inflight({"1": "b"})  # already known: kept
    out = [router2.doc(), router2.inflight_on("a"), router2.forget_engine("b")]
    router2.complete("1")
    router2.complete("nope")
    out.append(router2.doc())
    return out, records(log2)


def _seeded_stream(s):
    """60 requests over three replicas of unequal capacity, prompts drawn
    around four shared prefixes, tiers mixed, completions interleaved."""
    rng = np.random.RandomState(7)
    mem, router, log, reg = _router(s, {"a": 3, "b": 5, "c": 2}, shed_queue_depth=6)
    prefixes = [tuple(int(t) for t in rng.randint(0, 500, 4 * int(rng.randint(1, 4))))
                for _ in range(4)]
    out, live = [], []
    for i in range(60):
        prompt = prefixes[rng.randint(4)] + tuple(int(t) for t in rng.randint(0, 500,
                                                                            rng.randint(1, 9)))
        tier = "best_effort" if rng.rand() < 0.4 else "critical"
        d = router.route(str(i), prompt, tier)
        out.append(_decided(d))
        if d.engine is not None:
            live.append(str(i))
        if live and rng.rand() < 0.45:
            router.complete(live.pop(int(rng.randint(len(live)))))
        if i == 30:
            mem.cordon("b")
        if i == 45:
            mem.uncordon("b")
    return out, router.doc(), records(log), fleet_samples(reg), router.least_loaded({"a"})


ROUTES = {
    "warm_replica_sticks": _stickiness,
    "overflow_queues_least_loaded": _overflow,
    "no_replicas_when_cordoned": _no_replicas,
    "best_effort_shed_under_page": _shed_on_page,
    "best_effort_shed_on_queue_depth": _shed_on_queue_depth,
    "restart_seeds_inflight": _restart_seeding,
    "seeded_stream": _seeded_stream,
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routes_equal_the_references(name):
    got = both(ROUTES[name])
    if name == "warm_replica_sticks":
        out, doc = got[0], got[1]
        assert out[0][2] == "balanced" and out[1][2] == "affinity"
        assert out[1][1] == out[0][1] and out[1][4] == 2
        hits = sum(o[4] > 0 for o in out)
        assert doc["affinity_hits"] == hits and doc["affinity_hit_ratio"] == hits / 3
    elif name == "overflow_queues_least_loaded":
        assert [o[1:3] for o in got[0]] == [("a", "overflow"), ("b", "overflow"),
                                           ("a", "overflow")]
    elif name == "no_replicas_when_cordoned":
        assert [o[1:3] for o in got[0]] == [(None, "no_replicas"), ("a", "balanced"),
                                           (None, "no_replicas")]
    elif name == "best_effort_shed_under_page":
        assert got[0] == TS.SEVERITY_PAGE
        assert got[1][0][5] and got[1][1][1] == "a"  # critical is never shed
    elif name == "best_effort_shed_on_queue_depth":
        assert got[0][1][5] and got[0][2][1:3] == ("a", "overflow")
    elif name == "restart_seeds_inflight":
        assert got[0][0]["inflight"] == 2 and got[0][2] == ["7"]
        assert got[0][3]["inflight"] == 0
    else:
        outcomes = {o[2] for o in got[0]}
        assert {"affinity", "balanced", "shed"} <= outcomes


def test_router_checks_its_page_size():
    with pytest.raises(ValueError):
        TR.FleetRouter(TR.FleetMembership(), page_size=0)


def test_the_witness_checks_slo_budget_before_the_router():
    """The router reads the SLO budget (rank 64) before it takes
    ``fleet.router`` (76), and emits its record (65) after: a route under
    the witness records no inversion, and taking the budget while the
    router's lock is held is one."""
    lockrank.set_witness(True)
    lockrank.reset_violations()
    try:
        budget = TS.SloBudget(clock=lambda: 0.0)
        reg = TM.MetricsRegistry()
        mem = TR.FleetMembership(registry=reg)
        mem.add("a", None, capacity=2)
        router = TR.FleetRouter(mem, page_size=4, slo_budget=budget,
                                decisions=TD.DecisionLog(), registry=reg)
        assert router.route("1", (1, 2, 3, 4), tier="best_effort").engine == "a"
        mem.publish()
        lockrank.assert_clean("fleet route")
        with router._lock:
            budget.severity("critical")
        found = lockrank.violations()
        assert [(v.acquiring, v.holding) for v in found] == [("slo.budget", "fleet.router")]
    finally:
        lockrank.set_witness(None)
        lockrank.reset_violations()


# --- the journaled scale-down ------------------------------------------------


class FleetState:
    """The fleet as host dicts with exactly the side-effect shape
    ``serving/fleet.py`` binds: drain pops rows into a snapshot, migrate
    adopts idempotently by snapshot_id, requeue re-prefills rid-deduped.
    The dicts outlive a router incarnation (only its WAL restarts)."""

    def __init__(self):
        self.inflight = {"e0": [{"rid": "r0"}, {"rid": "r1"}], "e1": []}
        self.routable = {"e0": True, "e1": True}
        self.served: dict[str, list[str]] = {}
        self.adopted: set[str] = set()

    def adopt(self, snapshot):
        sid = str((snapshot or {}).get("snapshot_id", ""))
        rows = (snapshot or {}).get("rows") or []
        if not rows or sid in self.adopted:
            return 0
        self.adopted.add(sid)
        for row in rows:
            self.served.setdefault(str(row["rid"]), []).append("migrated")
        return len(rows)

    def cordon(self, engine):
        self.routable[engine] = False

    def rows_of(self, engine):
        return [dict(r) for r in self.inflight.get(engine, [])]

    def drain(self, engine):
        rows = self.inflight.get(engine, [])
        self.inflight[engine] = []
        return {"snapshot_id": f"snap-{engine}", "rows": [dict(r) for r in rows]}

    def release(self, engine):
        self.inflight.pop(engine, None)
        self.routable.pop(engine, None)

    def deliver(self, scale_id, record):
        self.adopt(record.get("snapshot") or {})
        self.release(str(record.get("engine", "")))

    def requeue(self, scale_id, record):
        engine = str(record.get("engine", ""))
        if engine in self.routable:
            self.routable[engine] = True
            return
        for row in record.get("rows") or []:
            rid = str(row["rid"])
            if rid not in self.served:
                self.served.setdefault(rid, []).append("requeued")

    def finish_sources(self):
        """Replicas still holding rows serve them themselves (a rollback
        re-opened the replica)."""
        for engine in sorted(self.inflight):
            for row in self.inflight[engine]:
                self.served.setdefault(str(row["rid"]), []).append("source")
            self.inflight[engine] = []


def _executor(s, state, path, mode="always"):
    reg = s.M.MetricsRegistry()
    ckpt = s.C.AllocationCheckpoint(str(path), fsync=mode)
    ex = s.R.ScaleExecutor(ckpt, s.A.AssumeCache(), cordon_fn=state.cordon,
                           rows_fn=state.rows_of, drain_fn=state.drain,
                           migrate_fn=lambda snap, record: state.adopt(snap),
                           release_fn=state.release, node=NODE, registry=reg, pod="ns/fleet")
    return ckpt, ex, reg


def _crash(s, state, path, site, mode="always"):
    """Incarnation 1 scales e0 down and dies at ``site`` (None: it
    completes). Returns its verdict, executor counters and samples."""
    ckpt, ex, reg = _executor(s, state, path, mode)
    if site is None:
        first = ex.execute("s1", "e0")
        ckpt.close()
    else:
        with s.F.FAULTS.injected(site, "crash", times=1):
            with pytest.raises(s.F.SimulatedCrash):
                ex.execute("s1", "e0")
        ckpt.abandon()
        first = "crashed"
    return first, ex.completed_ops, ex.migrated_requests, fleet_samples(reg)


def _resolve(resolver, state, path, mode="always", hooks=True):
    """Incarnation 2 (package ``resolver``): reopen the WAL and resolve
    every pending scale entry with the fleet's hooks, as a reconciler
    would; a second pass finds nothing."""
    ckpt = resolver.C.AllocationCheckpoint(str(path), fsync=mode)
    assume = resolver.A.AssumeCache()
    pending = ckpt.pending()
    outs = []
    for key, data in sorted(pending.items()):
        if data.get("kind") == "scale" and hooks:
            outs.append(resolver.R.resolve_scale(ckpt, assume, key, data,
                                                 deliver_fn=state.deliver,
                                                 requeue_fn=state.requeue))
    again = ckpt.pending()
    ckpt.close()
    return ([(k, d.get("phase"), d.get("rows"), d.get("snapshot")) for k, d in
             sorted(pending.items())], outs, again, assume.is_claimed(("tpushare-scale", "s1")))


@pytest.mark.parametrize("mode", ["always", "batch"])
@pytest.mark.parametrize("site", SITES)
def test_kill_at_every_scale_step_resolves_as_the_reference(site, mode, tmp_path):
    """Rolls forward at or past ``migrate``, back before it; both in-flight
    requests served exactly once, by the right path; the journal empty; the
    WAL files byte for byte the reference's."""

    def scenario(s):
        state = FleetState()
        path = tmp_path / s.R.__name__ / "wal.ckpt"
        path.parent.mkdir()
        crashed = _crash(s, state, path, site, mode)
        resolved = _resolve(s, state, path, mode)
        state.finish_sources()
        return crashed, resolved, state.served, state.routable, path.read_bytes()

    crashed, (pending, outs, again, claimed), served, routable, _ = both(scenario)
    forward = site in ("scale.migrate", "scale.release")
    assert all(len(v) == 1 for v in served.values()) and set(served) == {"r0", "r1"}
    if site is None:
        assert crashed[:3] == ("scaled", 1, 2) and pending == [] and outs == []
    else:
        assert [p[1] for p in pending] == [site.split(".")[1]]
        assert outs == ["rollforward" if forward else "rollback"]
    modes = sorted(m for v in served.values() for m in v)
    if site is None or forward:
        assert modes == ["migrated", "migrated"] and "e0" not in routable
    else:
        assert modes == ["source", "source"] and routable["e0"] is True
    assert again == {} and not claimed


@pytest.mark.parametrize("site", ["scale.cordon", "scale.drain"])
def test_rollback_requeues_when_the_victim_died_too(site, tmp_path):
    """A rollback cannot un-cordon a corpse: the journaled rows (durable
    since ``drain``) re-queue on survivors. At ``cordon`` nothing was
    journaled, and nothing is invented."""

    def scenario(s):
        state = FleetState()
        path = tmp_path / s.R.__name__ / "wal.ckpt"
        path.parent.mkdir()
        _crash(s, state, path, site)
        state.inflight.pop("e0", None)
        state.routable.pop("e0", None)
        return _resolve(s, state, path), state.served

    (_, outs, again, _), served = both(scenario)
    assert outs == ["rollback"] and again == {}
    assert served == ({"r0": ["requeued"], "r1": ["requeued"]} if site == "scale.drain" else {})


def test_resolve_stays_pending_while_delivery_fails(tmp_path):
    def scenario(s):
        ckpt = s.C.AllocationCheckpoint(str(tmp_path / f"{s.R.__name__}.wal"))
        key = s.R.scale_key("s1")
        data = {"kind": "scale", "scale_id": "s1", "engine": "e0", "phase": "migrate",
                "rows": [{"rid": "r0"}],
                "snapshot": {"snapshot_id": "snap-e0", "rows": [{"rid": "r0"}]}}
        data["_seq"] = ckpt.begin(key, dict(data))

        def dead(scale_id, record):
            raise RuntimeError("no survivor with headroom")

        out = [s.R.resolve_scale(ckpt, s.A.AssumeCache(), key, data, deliver_fn=dead),
               key in ckpt.pending()]
        state = FleetState()
        out.append(s.R.resolve_scale(ckpt, s.A.AssumeCache(), key, data,
                                     deliver_fn=state.deliver, requeue_fn=state.requeue))
        out += [ckpt.pending(), state.served]
        ckpt.close()
        return out

    assert both(scenario) == [None, True, "rollforward", {}, {"r0": ["migrated"]}]


def test_executor_skips_a_scale_already_claimed(tmp_path):
    def scenario(s):
        state = FleetState()
        ckpt, ex, reg = _executor(s, state, tmp_path / f"{s.R.__name__}.wal")
        assert ex._assume.claim(s.R.scale_key("s1"))
        out = [ex.execute("s1", "e0"), state.routable["e0"], ckpt.pending(),
               fleet_samples(reg)]
        ckpt.close()
        return out

    assert both(scenario)[:3] == ["skipped", True, {}]


@pytest.mark.parametrize("site", ["scale.drain", "scale.migrate"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_scale_journaled_by_one_package_resolves_in_the_other(writer, site, tmp_path):
    resolver = "port" if writer == "ref" else "ref"

    def run(res_side, sub):
        state = FleetState()
        path = tmp_path / sub / "wal.ckpt"
        path.parent.mkdir()
        _crash(SIDES[writer], state, path, site)
        return _resolve(SIDES[res_side], state, path), state.served, state.routable

    got, same = run(resolver, "cross"), run(writer, "same")
    assert got == same
    assert got[0][1] == ["rollforward" if site == "scale.migrate" else "rollback"]
    assert got[0][2] == {}


def test_fleet_constants_and_rank_entries_are_the_references():
    from gpushare_device_plugin_tpu import const as JConst
    from gpushare_device_plugin_tpu.utils import lockrank as JL

    assert const.FLEET_REPLICA_STATES == JConst.FLEET_REPLICA_STATES
    for name in ("slo.budget", "decisions.ring", "decisions.segment", "fleet.router",
                 "fleet.membership", "fleet.scale"):
        port, ref = lockrank.RANKS[name], JL.RANKS[name]
        assert (port.name, port.rank, port.kind, port.io_ok, port.doc) == (
            ref.name, ref.rank, ref.kind, ref.io_ok, ref.doc)
    assert [p for p in JF.POINTS if p.startswith("scale.")] == [
        p for p in TF.POINTS if p.startswith("scale.")]
    assert (TR.SCALE_PHASES, TR.SCALE_KIND, TR.SCALE_NS) == (JR.SCALE_PHASES, JR.SCALE_KIND,
                                                             JR.SCALE_NS)
