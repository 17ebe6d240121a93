"""The port's host-side paging modules (gpushare_device_plugin_tpu_torch/
serving/{pages,radix,drainproto}.py) against the reference's copies.

One seeded random sequence of allocator and radix operations drives both
copies; every return value, refcount, free count and hit statistic must
be equal after every step. The slice sizing must agree field for field
over a grid, and the drain handshake must answer the same in each case.
"""

import threading

import numpy as np
import pytest

from gpushare_device_plugin_tpu.serving import drainproto as JD
from gpushare_device_plugin_tpu.serving import engine as JE
from gpushare_device_plugin_tpu.serving import pages as JPG
from gpushare_device_plugin_tpu.serving import radix as JR
from gpushare_device_plugin_tpu_torch.serving import drainproto as D
from gpushare_device_plugin_tpu_torch.serving import pages as PG
from gpushare_device_plugin_tpu_torch.serving import radix as R

from torch_parity import configs


def _state(alloc, radix):
    return (
        alloc.free_pages, alloc.used_pages, alloc.high_water,
        [alloc.refcount(p) for p in range(alloc.total + 1)],
        radix.cached_pages, sorted(radix.pages()), radix.hit_tokens, radix.lookup_tokens,
        radix.hit_requests, radix.lookup_requests, radix.evicted_pages, radix.hit_ratio(),
    )


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_radix_equal_reference_step_by_step(seed):
    rng = np.random.RandomState(seed)
    ps, total = 2, 24
    pair = []
    for mod_pages, mod_radix in ((JPG, JR), (PG, R)):
        alloc = mod_pages.PageAllocator(total)
        pair.append((alloc, mod_radix.RadixCache(ps, alloc)))
    held: list[list[int]] = []  # page groups this test holds a reference on
    prompts = [tuple(int(x) for x in rng.randint(0, 3, size=rng.randint(1, 11))) for _ in range(8)]
    for _ in range(300):
        op = rng.choice(["alloc", "share", "release", "freeable", "insert", "match",
                         "evict", "record", "clear", "reset"])
        if op == "alloc":
            args = (int(rng.randint(0, 6)),)
        elif op in ("share", "release"):
            unused = [p for p in range(1, total + 1) if pair[0][0].refcount(p) == 0]
            if unused and (not held or rng.rand() < 0.1):
                args = ([unused[rng.randint(len(unused))]],)  # unallocated: both raise
            elif not held:
                continue
            else:
                args = (held.pop(rng.randint(len(held))) if op == "release"
                        else held[rng.randint(len(held))],)
        elif op == "freeable":
            groups = [g for g in held if rng.rand() < 0.5] + [pair[0][1].pages()]
            args = (groups,)
        elif op in ("insert", "match"):
            args = (prompts[rng.randint(len(prompts))],)
            count = bool(rng.rand() < 0.5)
        elif op == "evict":
            args = (int(rng.randint(0, 4)),)
        elif op == "record":
            args = (int(rng.randint(1, 20)), int(rng.randint(0, 5)))
        else:
            args = ()
        outs = []
        for alloc, radix in pair:
            if op == "insert":
                got = alloc.alloc(len(args[0]) // ps)
                out = None if got is None else (got, radix.insert(args[0], got))
                if got:
                    alloc.release(got)  # the inserting row retires
            elif op == "match":
                out = radix.match(args[0], count=count)
            elif op == "record":
                out = radix.record_lookup(*args)
            elif op == "clear":
                out = radix.clear()
            elif op == "reset":
                out = (alloc.reset_stats(), radix.reset_stats())
            elif op == "evict":
                out = radix.evict(*args)
            else:
                out = _outcome(getattr(alloc, op), *args)
            outs.append(out)
        assert outs[0] == outs[1], op
        if op == "alloc" and outs[0][1]:
            held.append(outs[0][1])
        if op == "share" and outs[0][0] == "ok":
            held.append(list(args[0]))
        if op == "match" and outs[0][1]:
            held.append(outs[0][1])
        assert _state(*pair[0]) == _state(*pair[1]), op


def test_allocator_and_radix_errors_equal_reference():
    for mod in (JPG, PG):
        with pytest.raises(ValueError, match="total_pages"):
            mod.PageAllocator(0)
        with pytest.raises(ValueError, match="n must be"):
            mod.PageAllocator(2).alloc(-1)
    for mod in (JR, R):
        with pytest.raises(ValueError, match="page_size"):
            mod.RadixCache(0, PG.PageAllocator(2))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_plan_equals_reference(kv_dtype):
    jcfg, tcfg = configs()
    for slice_bytes in (60_000, 400_000, 3_000_000, 2**31):
        for page_size in (4, 16):
            for prefill_chunk in (16, 64):
                for slots in (None, 3, 500):
                    kw = dict(page_size=page_size, weight_bytes=50_000,
                              prefill_chunk=prefill_chunk, kv_dtype=kv_dtype, slots=slots)
                    want = JPG.paged_plan_for_slice(slice_bytes, jcfg, 100, **kw)
                    got = PG.paged_plan_for_slice(slice_bytes, tcfg, 100, **kw)
                    assert got.__dict__ == want.__dict__, kw
                    assert got.pool_bytes == want.pool_bytes
    assert PG.pages_for(17, 4) == JPG.pages_for(17, 4) == 5
    assert PG.row_span_for(100, 64) == JPG.row_span_for(100, 64) == 128
    for bad in (dict(page_size=0), dict(headroom=0.0), dict(prefill_chunk=0)):
        kw = {**dict(page_size=4, weight_bytes=0), **bad}
        with pytest.raises(ValueError) as jerr:
            JPG.paged_plan_for_slice(10**6, jcfg, 100, **kw)
        with pytest.raises(ValueError) as terr:
            PG.paged_plan_for_slice(10**6, tcfg, 100, **kw)
        assert str(terr.value) == str(jerr.value)
    assert JE.kv_slot_bytes(jcfg, 16, kv_dtype) == PG.paged_plan_for_slice(
        2**31, tcfg, 100, page_size=16, weight_bytes=0, kv_dtype=kv_dtype
    ).page_bytes


def _doc(h):
    return (h.armed(), h.snapshot())


def _handshake_trace(mod, case):
    """Drive one handshake through ``case``; returns what each step said."""
    h = mod.DrainHandshake()
    out = [_doc(h)]
    if case == "capture":
        h.request()
        out.append(h.armed())
        h.publish({"requests": [1]})
        out += [h.wait(timeout=1.0), _doc(h)]
        h.finish_run()  # a later run's end keeps the uncollected capture
        out += [h.snapshot(), _doc(h)]
    elif case == "natural_end":
        h.request()
        h.finish_run()
        out += [h.wait(timeout=1.0), _doc(h), h.armed()]
    elif case == "timeout":
        h.request()
        try:
            h.wait(timeout=0.01)
        except TimeoutError as e:
            out.append(str(e))
        out += [h.armed(), _doc(h)]
    elif case == "rearm":
        h.finish_run()
        h.request()  # arming clears the earlier answer
        out.append(_doc(h))
        got = {}
        t = threading.Thread(target=lambda: got.setdefault("snap", h.wait(timeout=30.0)))
        t.start()
        h.publish({"requests": [2]})
        t.join(timeout=30.0)
        out += [t.is_alive(), got["snap"], _doc(h)]
    return out


@pytest.mark.parametrize("case", ["capture", "natural_end", "timeout", "rearm"])
def test_drain_handshake_equals_reference(case):
    assert _handshake_trace(D, case) == _handshake_trace(JD, case)
