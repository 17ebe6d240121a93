"""The port's KV-handoff protocol layer against the reference's, on the CPU.

The port keeps its own copies of the journaled handoff
(``serving/handoffproto.py``), the WAL (``allocator/checkpoint.py``), the
claim ledger (``allocator/assume.py``), the fault table, the retry and
circuit-breaker helpers and the group-commit batcher
(``gpushare_device_plugin_tpu_torch/utils``), and the page wire
(``serving/handoff.py`` ``encode_page`` / ``decode_page``). Every test
runs one scripted scenario through the reference and through the port
and compares the two exactly: ledger results and ``doc()`` after each
step, sink and mover outcomes, peer docs and breaker states, the journal
records of each phase and the WAL bytes, and the crash drill of
``tests/test_handoff.py`` (a kill at each ``handoff.*`` site in both
fsync modes, resolved from the journal alone by ``resolve_handoff``:
roll forward at or past ``import``, back before it, one delivery either
way). A WAL written by either package loads in the other, and a crash
journaled by one resolves in the other. The page wire: the port's bytes
equal the reference's for f32, int8 and bf16 pages (bf16 through its
16-bit words, no ``ml_dtypes``), each package decodes the other's, and
corruption raises.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpushare_device_plugin_tpu.allocator import assume as JA
from gpushare_device_plugin_tpu.allocator import checkpoint as JC
from gpushare_device_plugin_tpu.serving import handoff as JH
from gpushare_device_plugin_tpu.serving import handoffproto as JP
from gpushare_device_plugin_tpu.serving import pages as JPg
from gpushare_device_plugin_tpu.utils import circuit as JCir
from gpushare_device_plugin_tpu.utils import faults as JF
from gpushare_device_plugin_tpu_torch.allocator import assume as TA
from gpushare_device_plugin_tpu_torch.allocator import checkpoint as TC
from gpushare_device_plugin_tpu_torch.serving import handoff as TH
from gpushare_device_plugin_tpu_torch.serving import handoffproto as TP
from gpushare_device_plugin_tpu_torch.serving import pages as TPg
from gpushare_device_plugin_tpu_torch.utils import circuit as TCir
from gpushare_device_plugin_tpu_torch.utils import faults as TF
from gpushare_device_plugin_tpu_torch.utils import lockrank

NODE = "node-handoff"
SITES = [None, "handoff.export", "handoff.transfer", "handoff.import", "handoff.commit"]


def _side(ref):
    if ref:
        return types.SimpleNamespace(P=JP, H=JH, C=JC, A=JA, Pg=JPg, F=JF, Cir=JCir)
    return types.SimpleNamespace(P=TP, H=TH, C=TC, A=TA, Pg=TPg, F=TF, Cir=TCir)


SIDES = {"ref": _side(True), "port": _side(False)}


@pytest.fixture(autouse=True)
def _clean_faults():
    JF.FAULTS.clear()
    TF.FAULTS.clear()
    yield
    JF.FAULTS.clear()
    TF.FAULTS.clear()


class DecodeTier:
    """A decode tier without an engine: a page pool, the staging ledger and
    the sink, whose import callback adopts the pages (and releases them, as
    the row's retirement would) and whose re-prefill callback records the
    row (``tests/test_handoff.py``'s harness)."""

    def __init__(self, m, total_pages=8):
        self.pool = m.Pg.PageAllocator(total_pages)
        self.ledger = m.P.HandoffImportLedger()
        self.served: dict[str, list[str]] = {}
        self.sink = m.P.HandoffSink(self.ledger, self.pool.alloc, self.pool.release,
                                    self._import_cb, self._reprefill_cb)

    def _import_cb(self, pages, blobs, meta, record):
        self.served.setdefault(record["handoff_id"], []).append("kv")
        self.pool.release(pages)

    def _reprefill_cb(self, record):
        self.served.setdefault(record["handoff_id"], []).append("reprefill")

    def clean(self):
        return (self.pool.free_pages == self.pool.total and self.ledger.pages_in_flight == 0
                and self.ledger.doc()["staged"] == {})


def mk_plan(m, hid, n_pages=2):
    return m.P.HandoffPlan(
        handoff_id=hid,
        request={"rid": 7, "prompt": [1, 2, 3], "tokens": [9], "max_new": 4,
                 "tier": "critical", "adapter_id": "t0"},
        meta={"page_size": 4, "kv_dtype": None, "eos_id": 3, "pos": 3, "n_pages": n_pages},
        pages=tuple(f"kv-{hid}-{i}".encode() for i in range(n_pages)),
    )


def both(fn):
    """Run ``fn(side)`` on the reference and on the port; their results."""
    return fn(SIDES["ref"]), fn(SIDES["port"])


# --- ledger, sink, peer, mover ------------------------------------------------


def test_ledger_sequences_and_docs_equal_reference():
    def script(m):
        pool = m.Pg.PageAllocator(5)
        led = m.P.HandoffImportLedger(dedup_window=2)
        log = []

        def step(name, fn):
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — the error is the result
                out = (type(e).__name__, str(e))
            log.append((name, out, led.doc(), led.pages_in_flight, pool.free_pages))

        blob = b"page-bytes"
        crc = m.P.page_crc(blob)
        step("stage h1", lambda: led.stage("h1", 2, {"page_size": 4}, pool.alloc))
        step("restage h1", lambda: led.stage("h1", 2, {}, pool.alloc))
        step("stage h2 (too big)", lambda: led.stage("h2", 4, {}, pool.alloc))
        step("stage h3", lambda: led.stage("h3", 3, {}, pool.alloc))
        step("stage zero", lambda: led.stage("h4", 0, {}, pool.alloc))
        step("bad crc", lambda: led.put_page("h1", 0, blob, crc ^ 1))
        step("not staged", lambda: led.put_page("nope", 0, blob, crc))
        step("out of range", lambda: led.put_page("h1", 5, blob, crc))
        step("put 0", lambda: led.put_page("h1", 0, blob, crc))
        step("adopt partial", lambda: led.adopt("h1"))
        step("put 1", lambda: led.put_page("h1", 1, blob + b"!", m.P.page_crc(blob + b"!")))
        step("adopt sealed", lambda: led.adopt("h1"))
        step("abort h3", lambda: led.abort("h3", pool.release))
        step("abort h3 again", lambda: led.abort("h3", pool.release))
        for hid in ("h1", "h1", "h2", "h3", "h1"):
            step(f"first {hid}", lambda hid=hid: led.first_delivery(hid))
            step(f"delivered {hid}", lambda hid=hid: led.delivered(hid))
        step("stage delivered h3", lambda: led.stage("h3", 1, {}, pool.alloc))
        return log

    ref, port = both(script)
    assert port == ref
    assert ("adopt sealed", ([1, 2], [b"page-bytes", b"page-bytes!"], {"page_size": 4})) == \
        port[11][:2]


def test_sink_is_idempotent_and_degrades_as_the_reference():
    def script(m):
        tier = DecodeTier(m)
        out = []
        rec = {"handoff_id": "h1", "request": {"rid": 1}}
        out.append(tier.sink.deliver("h1", rec))  # nothing staged: re-prefill
        out.append(tier.sink.deliver("h1", rec))  # duplicate
        tier.sink.stage("h2", 2, {})
        tier.ledger.first_delivery("h2")  # a racing transfer staged after delivery
        out.append(tier.sink.deliver("h2", {"handoff_id": "h2"}))
        tier.sink.stage("h3", 2, {})
        for i in range(2):
            tier.sink.put_page("h3", i, b"kv", m.P.page_crc(b"kv"))
        out.append(tier.sink.deliver("h3", {"handoff_id": "h3", "request": {}}))
        tier.sink.stage("h4", 2, {})
        tier.sink.put_page("h4", 0, b"kv", m.P.page_crc(b"kv"))  # partial
        out.append(tier.sink.deliver("h4", {"handoff_id": "h4", "request": {}}))
        out.append(tier.sink.abort("h4"))

        served = []

        def bad_import(pages, blobs, meta, record):
            raise ValueError("geometry mismatch")

        pool = m.Pg.PageAllocator(4)
        sink = m.P.HandoffSink(m.P.HandoffImportLedger(), pool.alloc, pool.release, bad_import,
                               lambda record: served.append(record["handoff_id"]))
        sink.stage("h5", 2, {})
        for i in range(2):
            sink.put_page("h5", i, b"kv", m.P.page_crc(b"kv"))
        out.append(sink.deliver("h5", {"handoff_id": "h5", "request": {}}))
        return out, tier.served, tier.clean(), served, pool.free_pages, tier.ledger.doc()

    ref, port = both(script)
    assert port == ref
    assert port[0] == ["reprefill", "duplicate", "duplicate", "imported", "reprefill", False,
                       "reprefill"]


class FlakyTransport:
    """Fails the first ``n`` calls, then delegates."""

    def __init__(self, inner, n=1):
        self._inner, self._n, self.failures = inner, n, 0

    def _maybe(self):
        if self.failures < self._n:
            self.failures += 1
            raise ConnectionError("blip")

    def stage(self, *a):
        self._maybe()
        return self._inner.stage(*a)

    def put_page(self, *a):
        self._maybe()
        return self._inner.put_page(*a)

    def deliver(self, *a):
        self._maybe()
        return self._inner.deliver(*a)

    def abort(self, *a):
        self._maybe()
        return self._inner.abort(*a)


@pytest.mark.parametrize("blips", [0, 2, 5])
def test_peer_retries_through_a_flaky_transport_as_the_reference(blips, tmp_path):
    def script(m):
        tier = DecodeTier(m)
        ckpt = m.C.AllocationCheckpoint(str(tmp_path / f"{m.P.__name__}-{blips}.wal"))
        peer = m.P.HandoffPeerClient(FlakyTransport(tier.sink, n=blips), sleep=lambda s: None)
        mover = m.P.HandoffMover(ckpt, m.A.AssumeCache(), peer, fallback_fn=tier.sink.deliver,
                                 node=NODE)
        outs = [mover.execute(mk_plan(m, f"h{i}")) for i in range(3)]
        pending = ckpt.pending()
        ckpt.close()
        return outs, peer.doc(), tier.served, tier.clean(), pending

    ref, port = both(script)
    assert port == ref
    assert port[0][0] == ("delivered" if blips < 3 else "fallback")


def test_breaker_opens_fails_fast_and_probes_as_the_reference():
    """Every call of a dead transport fails: five consecutive failures open
    the breaker, an open breaker is not retried (``CircuitOpenError``), and
    after the reset window one probe is let through."""

    class Dead:
        def __getattr__(self, name):
            def verb(*a):
                raise ConnectionError("down")
            return verb

    def script(m):
        now = [0.0]
        breaker = m.Cir.CircuitBreaker("t-breaker", failure_threshold=5, reset_timeout_s=1.0,
                                       clock=lambda: now[0])
        peer = m.P.HandoffPeerClient(Dead(), attempts=3, breaker=breaker, sleep=lambda s: None,
                                     clock=lambda: now[0])
        log = []
        for i in range(4):
            try:
                peer.stage(f"h{i}", 1, {})
            except Exception as e:  # noqa: BLE001
                log.append((type(e).__name__, type(getattr(e, "last", None)).__name__,
                            getattr(e, "attempts", None), breaker.state))
        now[0] = 2.0
        log.append(breaker.state)
        try:
            peer.stage("probe", 1, {})
        except Exception as e:  # noqa: BLE001
            log.append((type(e).__name__, breaker.state))
        return log, peer.doc()

    ref, port = both(script)
    assert port == ref
    assert port[0][1][1] == "CircuitOpenError" and port[0][-2] == "half-open"


def test_mover_skips_a_claimed_handoff_as_the_reference(tmp_path):
    def script(m):
        tier = DecodeTier(m)
        ckpt = m.C.AllocationCheckpoint(str(tmp_path / f"{m.P.__name__}.wal"))
        assume = m.A.AssumeCache()
        mover = m.P.HandoffMover(ckpt, assume, m.P.HandoffPeerClient(tier.sink),
                                 fallback_fn=tier.sink.deliver, node=NODE)
        key = m.P.handoff_key("h1")
        out = [assume.claim(key), mover.execute(mk_plan(m, "h1"))]
        assume.release(key)
        out += [mover.execute(mk_plan(m, "h1")), assume.is_claimed(key), ckpt.pending()]
        ckpt.close()
        return out, tier.served

    ref, port = both(script)
    assert port == ref
    assert port[0][:3] == [True, "skipped", "delivered"]


class _RecordingCheckpoint:
    """Wraps a checkpoint, recording every journal call the mover makes."""

    def __init__(self, inner):
        self._inner, self.calls = inner, []

    def begin(self, key, data):
        self.calls.append(("begin", key, json.loads(json.dumps(data))))
        return self._inner.begin(key, data)

    def commit(self, key, seq=None):
        self.calls.append(("commit", key, seq))
        return self._inner.commit(key, seq=seq)

    def abort(self, key, seq=None):
        self.calls.append(("abort", key, seq))
        return self._inner.abort(key, seq=seq)


@pytest.mark.parametrize("path", ["delivered", "fallback"])
def test_journal_records_of_every_phase_equal_reference(path, tmp_path):
    def script(m):
        tier = DecodeTier(m)
        wal = tmp_path / f"{m.P.__name__}.wal"
        rec = _RecordingCheckpoint(m.C.AllocationCheckpoint(str(wal), fsync="always"))
        transport = tier.sink if path == "delivered" else m.H.BrokenTransport()
        peer = m.P.HandoffPeerClient(transport, attempts=2, sleep=lambda s: None)
        mover = m.P.HandoffMover(rec, m.A.AssumeCache(), peer, fallback_fn=tier.sink.deliver,
                                 node=NODE)
        out = mover.execute(mk_plan(m, "h1", n_pages=3))
        rec._inner.close()
        return out, rec.calls, wal.read_bytes(), tier.served

    ref, port = both(script)
    assert port == ref
    phases = [c[2]["phase"] for c in port[1] if c[0] == "begin"]
    if path == "delivered":
        assert port[0] == "delivered" and phases == ["export", "transfer", "import", "commit"]
        assert port[1][-1][0] == "commit"
    else:
        assert port[0] == "fallback" and phases == ["export", "transfer"]
        assert port[1][-1][0] == "abort"


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("mode", ["always", "batch"])
def test_a_wal_written_by_either_package_loads_in_the_other(writer, mode, tmp_path):
    """Begins, commits, aborts, a torn tail and a compaction: the other
    package's checkpoint sees the same pending entries and generation, and
    its own records append to the file."""
    w, r = SIDES[writer], SIDES["port" if writer == "ref" else "ref"]
    path = str(tmp_path / "wal.ckpt")
    ck = w.C.AllocationCheckpoint(path, fsync=mode)
    seqs = {k: ck.begin(("ns", k), {"kind": "handoff", "phase": "import", "n": i})
            for i, k in enumerate("abcd")}
    ck.commit(("ns", "a"), seq=seqs["a"])
    ck.abort(("ns", "b"))
    ck.begin(("ns", "c"), {"kind": "handoff", "phase": "commit"})
    ck.flush()
    want = ck.pending()
    ck.close()
    with open(path, "ab") as f:
        f.write(b'{"op": "begin", "key": ["ns", "torn"')  # a crash mid-append
    other = r.C.AllocationCheckpoint(path, fsync=mode)
    assert other.pending() == want and other.generation == 2
    other.commit(("ns", "d"), seq=want[("ns", "d")]["_seq"])
    other.compact()
    left = other.pending()
    other.close()
    back = w.C.AllocationCheckpoint(path, fsync=mode)
    assert back.pending() == left == {("ns", "c"): want[("ns", "c")]}
    assert back.generation == 3
    back.close()


def test_fencing_equals_reference(tmp_path):
    class Api:
        def __init__(self):
            self.node = {"metadata": {"annotations": {}}}

        def get_node(self, name):
            return self.node

        def patch_node(self, name, patch):
            self.node["metadata"]["annotations"].update(patch["metadata"]["annotations"])

    def script(m):
        api = Api()
        a = m.C.AllocationCheckpoint(str(tmp_path / f"{m.P.__name__}-a.wal"))
        b = m.C.AllocationCheckpoint(str(tmp_path / f"{m.P.__name__}-b.wal"))
        out = [a.acquire_fence(api, NODE), b.acquire_fence(api, NODE),
               b.verify_fence(api, NODE), a.verify_fence(api, NODE), a.fenced]
        try:
            a.begin(("ns", "x"), {})
        except m.C.StaleDaemonError as e:
            out.append(type(e).__name__)
        out.append(b.begin(("ns", "x"), {}))
        a.close()
        b.close()
        return out

    ref, port = both(script)
    assert port == ref == [1, 2, True, False, True, "StaleDaemonError", 1]


# --- the crash drill ----------------------------------------------------------


def _crash_then_resolve(writer, resolver, site, mode, tmp_path, tier_side=None, fresh_tier=False):
    """Incarnation 1 (package ``writer``) runs one handoff and dies at
    ``site``; incarnation 2 (package ``resolver``) reopens the WAL and
    resolves every pending handoff entry onto the decode tier (the one that
    survived, or a fresh one when ``fresh_tier``)."""
    w, r = SIDES[writer], SIDES[resolver]
    t = SIDES[tier_side or resolver]
    path = str(tmp_path / "wal.ckpt")
    tier = DecodeTier(t)
    ck1 = w.C.AllocationCheckpoint(path, fsync=mode)
    mover = w.P.HandoffMover(ck1, w.A.AssumeCache(),
                             w.P.HandoffPeerClient(tier.sink, sleep=lambda s: None),
                             fallback_fn=tier.sink.deliver, node=NODE)
    if site is None:
        first = mover.execute(mk_plan(w, "h1"))
    else:
        with w.F.FAULTS.injected(site, "crash", times=1):
            with pytest.raises(w.F.SimulatedCrash):
                mover.execute(mk_plan(w, "h1"))
        first = "crashed"
        ck1.abandon()
    if fresh_tier:
        tier = DecodeTier(t)
    ck2 = r.C.AllocationCheckpoint(path, fsync=mode)
    assume2 = r.A.AssumeCache()
    pending = ck2.pending()
    outs = [r.P.resolve_handoff(ck2, assume2, key, data, deliver_fn=tier.sink.deliver,
                                abort_fn=tier.sink.abort)
            for key, data in sorted(pending.items()) if data.get("kind") == "handoff"]
    again = ck2.pending()
    ck2.close()
    return (first, sorted(pending), [d.get("phase") for _, d in sorted(pending.items())], outs,
            tier.served, tier.clean(), again, assume2.is_claimed(r.P.handoff_key("h1")))


@pytest.mark.parametrize("mode", ["always", "batch"])
@pytest.mark.parametrize("site", SITES)
def test_kill_at_every_handoff_step_resolves_as_the_reference(site, mode, tmp_path):
    """A kill at each journal boundary through the port's ``FAULTS``,
    resolved by the port's ``resolve_handoff`` from the WAL alone, equals
    the reference's drill: roll forward at or past ``import`` (the staged
    KV adopts), back before it (the journaled row re-prefills), the request
    served exactly once, no page leaked, the journal empty."""
    ref = _crash_then_resolve("ref", "ref", site, mode, tmp_path / "ref")
    port = _crash_then_resolve("port", "port", site, mode, tmp_path / "port")
    assert port == ref
    first, keys, phases, outs, served, clean, again, claimed = port
    forward = site in ("handoff.import", "handoff.commit")
    if site is None:
        assert first == "delivered" and keys == [] and outs == []
    else:
        assert phases == [site.split(".")[1]]
        assert outs == ["rollforward" if forward else "rollback"]
    assert served == {"h1": ["kv" if site is None or forward else "reprefill"]}
    assert clean and again == {} and not claimed


@pytest.mark.parametrize("site", ["handoff.transfer", "handoff.import"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_crash_journaled_by_one_package_resolves_in_the_other(writer, site, tmp_path):
    """The same drill across packages, with a decode tier that died too
    (its staging is gone): the other package's resolver serves the request
    once, by re-prefill, and the journal ends empty."""
    resolver = "port" if writer == "ref" else "ref"
    got = _crash_then_resolve(writer, resolver, site, "always", tmp_path, fresh_tier=True)
    same = _crash_then_resolve(writer, writer, site, "always", tmp_path / "same",
                               tier_side=resolver, fresh_tier=True)
    assert got == same
    assert got[3] == ["rollforward" if site == "handoff.import" else "rollback"]
    assert got[4] == {"h1": ["reprefill"]} and got[5] and got[6] == {}


def test_resolve_stays_pending_while_delivery_fails(tmp_path):
    def script(m):
        tier = DecodeTier(m)
        ck = m.C.AllocationCheckpoint(str(tmp_path / f"{m.P.__name__}.wal"))
        key = m.P.handoff_key("h1")
        data = {"kind": "handoff", "handoff_id": "h1", "phase": "import",
                "request": {"rid": 1}, "n_pages": 1}
        seq = ck.begin(key, data)

        def dead(hid, record):
            raise RuntimeError("decode tier rebooting")

        out = [m.P.resolve_handoff(ck, None, key, {**data, "_seq": seq}, deliver_fn=dead),
               key in ck.pending()]
        out.append(m.P.resolve_handoff(ck, None, key, {**data, "_seq": seq},
                                       deliver_fn=tier.sink.deliver, abort_fn=tier.sink.abort))
        out += [ck.pending(), tier.served]
        ck.close()
        return out

    ref, port = both(script)
    assert port == ref == [None, True, "rollforward", {}, {"h1": ["reprefill"]}]


def test_fault_sites_parse_and_fire_as_the_reference():
    spec = ("handoff.transfer=error:2,handoff.import=latency:0,"
            "checkpoint.begin=flap:1/2,bogus.point=error,handoff.commit=crash:1")
    assert TF.FAULTS.install_from_env(spec) == JF.FAULTS.install_from_env(spec) == 4
    assert TF.FAULTS.active() == JF.FAULTS.active()
    got = {}
    for name, reg, crash in (("ref", JF.FAULTS, JF.SimulatedCrash),
                             ("port", TF.FAULTS, TF.SimulatedCrash)):
        log = []
        for point in ["handoff.transfer"] * 3 + ["checkpoint.begin"] * 4 + ["handoff.commit"] * 2:
            try:
                reg.fire(point)
                log.append("ok")
            except crash:
                log.append("crash")
            except ConnectionError as e:
                log.append(type(e).__name__)
        got[name] = (log, [reg.fired(p) for p in reg.active()])
    assert got["port"] == got["ref"]


def test_the_protocol_takes_its_locks_in_rank_order(tmp_path):
    """Under the lock witness, a delivered handoff, a fallback and a
    resolution record no inversion."""
    lockrank.set_witness(True)
    lockrank.reset_violations()
    try:
        tier = DecodeTier(SIDES["port"])
        ck = TC.AllocationCheckpoint(str(tmp_path / "wal.ckpt"))
        for transport in (tier.sink, TH.BrokenTransport()):
            peer = TP.HandoffPeerClient(transport, attempts=2, sleep=lambda s: None)
            mover = TP.HandoffMover(ck, TA.AssumeCache(), peer, fallback_fn=tier.sink.deliver)
            mover.execute(mk_plan(SIDES["port"], f"h{id(transport)}"))
        ck.close()
        assert tier.served and tier.clean()
        lockrank.assert_clean("handoff")
    finally:
        lockrank.set_witness(None)
        lockrank.reset_violations()


# --- the page wire ------------------------------------------------------------


def _pages():
    """The same page contents as the reference holds them (numpy, bf16 via
    ml_dtypes) and as the port does (host tensors)."""
    rng = np.random.RandomState(0)
    f32 = {"k": rng.randn(2, 4, 2, 8).astype(np.float32),
           "v": rng.randn(2, 4, 2, 8).astype(np.float32)}
    q8 = {"k": rng.randint(-127, 128, (2, 4, 2, 8)).astype(np.int8),
          "v": rng.randint(-127, 128, (2, 4, 2, 8)).astype(np.int8),
          "k_scale": rng.rand(2, 4, 2).astype(np.float32),
          "v_scale": rng.rand(2, 4, 2).astype(np.float32)}
    bf = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in f32.items()}
    port_bf = {k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
               for k, v in bf.items()}
    return {"f32": (f32, {k: torch.from_numpy(v) for k, v in f32.items()}),
            "int8": (q8, {k: torch.from_numpy(v) for k, v in q8.items()}),
            "bf16": (bf, port_bf)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_page_wire_bytes_equal_the_references_and_cross_decode(kind):
    ref_page, port_page = _pages()[kind]
    wire = JH.encode_page(ref_page)
    assert TH.encode_page(port_page) == wire
    assert TH.encode_page(dict(reversed(list(port_page.items())))) == wire
    # non-contiguous host slices (what fetch_kv_pages hands out) too
    stacked = {k: torch.stack([v, v], dim=1) for k, v in port_page.items()}
    assert TH.encode_page({k: v[:, 1] for k, v in stacked.items()}) == wire
    if kind == "bf16":
        head = json.loads(wire[4:4 + int.from_bytes(wire[:4], "little")])
        assert [e[1] for e in head] == ["bfloat16", "bfloat16"]
        assert len(wire) == 4 + int.from_bytes(wire[:4], "little") + 2 * 2 * 2 * 4 * 2 * 8
    port_out = TH.decode_page(wire)
    ref_out = JH.decode_page(TH.encode_page(port_page))
    assert set(port_out) == set(ref_out) == set(ref_page)
    for key, val in ref_page.items():
        assert str(ref_out[key].dtype) == str(val.dtype)
        np.testing.assert_array_equal(_bits(port_out[key]), _bits(val))
        np.testing.assert_array_equal(_bits(ref_out[key]), _bits(val))
        assert port_out[key].dtype == port_page[key].dtype
    assert TP.page_crc(TH.encode_page(port_page)) == JP.page_crc(wire)


@pytest.mark.parametrize("cut", ["truncated", "trailing", "short", "header", "dtype"])
def test_corrupt_page_payloads_raise_as_the_reference(cut):
    ref_page, port_page = _pages()["bf16"]
    wire = TH.encode_page(port_page)
    hlen = int.from_bytes(wire[:4], "little")
    bad = {
        "truncated": wire[:-3],
        "trailing": wire + b"xx",
        "short": wire[:2],
        "header": wire[:4 + hlen - 2],
        "dtype": wire.replace(b"bfloat16", b"bfloat99", 1),
    }[cut]
    for decode in (TH.decode_page, JH.decode_page):
        with pytest.raises((ValueError, TypeError, AttributeError)):
            decode(bad)
    with pytest.raises(ValueError):
        TH.decode_page(bad)
