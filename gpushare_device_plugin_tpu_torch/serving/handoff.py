"""Disaggregated prefill/decode serving: the engine side of the KV handoff.

Counterpart of ``gpushare_device_plugin_tpu/serving/handoff.py``. The
protocol half (journal phases, import ledger, idempotent delivery sink,
retrying peer client, crash resolution) lives in ``handoffproto.py``.
This module binds it to two :class:`~.engine.PagedSlotEngine` instances:

- **the page wire**: :func:`encode_page` / :func:`decode_page` turn one
  page's cache buffers into wire bytes and back, checksummed per page by
  :func:`~.handoffproto.page_crc`. The bytes are the reference's for the
  same page: a length-prefixed JSON header of ``[key, dtype, shape]``
  triples, then each buffer's raw bytes. A bf16 buffer travels as its
  16-bit words under the dtype name ``"bfloat16"`` (2 bytes an element),
  so a page made by either package decodes in the other; the port reads
  it without ``ml_dtypes``.
- :class:`DisaggServer`: a PREFILL engine fills paged KV and produces
  each request's first token, a :class:`~.handoffproto.HandoffMover`
  ships the pages to the DECODE engine through the journaled
  export→transfer→import→commit protocol, and the decode engine adopts
  them straight into decode state (no second prefill). A failed or
  timed-out transfer, or a prefill tier that is down, degrades to local
  re-prefill on the decode tier: the request is never lost.

Both engines keep their own tick clocks; the decode tier sees a handed-off
request arrive ``first_token_tick + transfer-delay`` ticks into its own
clock, so end-to-end TTFT reads off the prefill tier and TPOT off the
decode tier.

One repair against the reference: the decode tier's request carries the
row's ``adapter_id``, so a LoRA tenant's imported row decodes (and
re-prefills) under its own adapter and its pages go into that adapter's
radix tree (``ROADMAP.md`` §3, fault 6).
"""

from __future__ import annotations

import json
import math
import struct
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..allocator.checkpoint import AllocationCheckpoint
from ..utils.log import get_logger
from ..utils.metrics import REGISTRY, MetricsRegistry
from .engine import PagedSlotEngine, Request, ServeStats
from .handoffproto import (
    HandoffError,
    HandoffImportLedger,
    HandoffMover,
    HandoffPeerClient,
    HandoffPlan,
    HandoffSink,
)

log = get_logger("serving.handoff")

_HEADER = struct.Struct("<I")


def _wire_array(val: Any) -> tuple[str, bytes]:
    """(dtype name, raw bytes) of one page buffer: a host tensor (bf16 as
    its 16-bit words) or a numpy array, named as numpy names it."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(val)
    return str(arr.dtype), arr.tobytes()


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"page payload names an unknown dtype {name!r}")
    return dt


def encode_page(blob: Mapping[str, Any]) -> bytes:
    """Serialize one page (a dict of per-buffer host tensors or numpy
    arrays, as :meth:`~.engine.PagedSlotEngine.fetch_kv_pages` or
    ``export_kv_pages`` give it) to wire bytes: a length-prefixed JSON
    header of ``[key, dtype, shape]`` triples, then each buffer's raw bytes
    in header order. Keys are sorted, so the same contents always give the
    same bytes (and the same CRC)."""
    entries = []
    parts: list[bytes] = []
    for key in sorted(blob):
        name, raw = _wire_array(blob[key])
        entries.append([key, name, list(blob[key].shape)])
        parts.append(raw)
    head = json.dumps(entries).encode("utf-8")
    return b"".join([_HEADER.pack(len(head)), head] + parts)


def decode_page(wire: bytes) -> dict[str, torch.Tensor]:
    """Inverse of :func:`encode_page` (the reference's bytes included):
    one host tensor per buffer, bf16 as bf16. Raises ``ValueError`` on a
    malformed payload (truncated buffer, trailing bytes, unknown dtype) —
    corruption the per-page CRC should have caught, so a raise here means
    the import degrades to re-prefill rather than adopting garbage."""
    if len(wire) < _HEADER.size:
        raise ValueError("page payload shorter than its header prefix")
    (hlen,) = _HEADER.unpack_from(wire, 0)
    off = _HEADER.size + hlen
    if off > len(wire):
        raise ValueError("page payload truncated inside its header")
    entries = json.loads(wire[_HEADER.size:off].decode("utf-8"))
    buf = bytearray(wire)  # one writable copy; every buffer is a view of it
    out: dict[str, torch.Tensor] = {}
    for key, dtype_name, shape in entries:
        dtype = _torch_dtype(str(dtype_name))
        shape = [int(d) for d in shape]
        count = int(np.prod(shape, dtype=np.int64))
        size = torch.empty((), dtype=dtype).element_size() * count
        if off + size > len(wire):
            raise ValueError(f"page payload truncated in buffer {key!r}")
        flat = (torch.frombuffer(buf, dtype=dtype, count=count, offset=off) if count
                else torch.empty(0, dtype=dtype))
        out[str(key)] = flat.reshape(shape)
        off += size
    if off != len(wire):
        raise ValueError(f"{len(wire) - off} trailing bytes in page payload")
    return out


def build_handoff_plan(export: Mapping[str, Any], handoff_id: str) -> HandoffPlan:
    """Turn one engine export (:meth:`PagedSlotEngine._export_handoff`)
    into the mover's :class:`HandoffPlan`: pages serialized to wire bytes,
    request row and geometry meta carried as they are (they ride inside
    every journal record: the re-prefill guarantee)."""
    return HandoffPlan(
        handoff_id=handoff_id,
        request=dict(export["request"]),
        meta=dict(export["meta"]),
        pages=tuple(encode_page(b) for b in export["pages"]),
    )


class BrokenTransport:
    """A page-transfer path that is down: every verb raises. Wired in
    place of the in-process sink it forces the mover down the degradation
    ladder; the fallback delivery still reaches the decode tier over the
    control path."""

    def stage(self, *a: Any, **k: Any) -> bool:
        raise HandoffError("transfer path down (injected)")

    def put_page(self, *a: Any, **k: Any) -> None:
        raise HandoffError("transfer path down (injected)")

    def deliver(self, *a: Any, **k: Any) -> str:
        raise HandoffError("transfer path down (injected)")

    def abort(self, *a: Any, **k: Any) -> bool:
        raise HandoffError("transfer path down (injected)")


def _fresh_wire() -> dict[str, float]:
    return dict.fromkeys(
        ("pages", "bytes", "fetch_s", "encode_s", "mover_s", "decode_s", "h2d_s"), 0)


def _sync(engine: PagedSlotEngine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


class DisaggServer:
    """Two-tier serving plane over one prefill and one decode
    :class:`PagedSlotEngine` (same model params; the geometry that KV
    import needs — eos, kv dtype, page size — must match, and a mismatch
    merely degrades to re-prefill).

    :meth:`serve` co-simulates the tiers: the prefill run exports each
    request at first-token time and the mover ships its pages inline
    (journaled when a ``checkpoint`` is given; unjournaled otherwise, like
    admissions on a sick disk); the decode run then serves every handed-off
    request, each arriving ``transfer-delay`` ticks after its prefill
    finished on the decode tier's own clock. ``transport`` overrides the
    page path (:class:`BrokenTransport` forces the fallback ladder); the
    control path — fallback delivery, dedup — always reaches the real sink.

    :attr:`wire` keeps the last serve's handoff costs on the host's clock:
    pages and bytes shipped, and the seconds of the device-to-host fetch
    (``fetch_s``), the encode (``encode_s``), the whole mover
    (``mover_s``: CRCs, staging, transfer and the import callback), the
    decode (``decode_s``) and the host-to-device write (``h2d_s``), each
    copy's end waited for.
    """

    def __init__(
        self,
        prefill: PagedSlotEngine,
        decode: PagedSlotEngine,
        *,
        checkpoint: AllocationCheckpoint | None = None,
        assume: Any = None,
        node: str = "local",
        transfer_pages_per_tick: int = 16,
        transport: Any = None,
        peer_kwargs: Mapping[str, Any] | None = None,
        registry: MetricsRegistry = REGISTRY,
        pod: str = "",
    ) -> None:
        if transfer_pages_per_tick < 1:
            raise ValueError(
                "transfer_pages_per_tick must be >= 1, got "
                f"{transfer_pages_per_tick}"
            )
        self.prefill = prefill
        self.decode = decode
        self._node = node
        self._xfer_rate = int(transfer_pages_per_tick)
        self._registry = registry
        self._pod = pod
        self.ledger = HandoffImportLedger()
        self.sink = HandoffSink(
            self.ledger,
            decode.allocator.alloc,
            decode.allocator.release,
            self._import_cb,
            self._reprefill_cb,
            registry=registry,
            pod=pod,
        )
        kw = dict(peer_kwargs or {})
        # co-simulated ticks, not wall clock: never really sleep between
        # retry attempts unless the caller asks for it
        kw.setdefault("sleep", lambda s: None)
        self.peer = HandoffPeerClient(
            transport if transport is not None else self.sink, **kw
        )
        self.mover = HandoffMover(
            checkpoint,
            assume,
            self.peer,
            fallback_fn=self.sink.deliver,
            node=node,
            registry=registry,
            pod=pod,
        )
        self._gen = 0
        # per-serve bookkeeping (reset by serve())
        self._exports: dict[int, dict] = {}
        self._deliveries: dict[int, dict] = {}
        self.outcomes: dict[str, int] = {}
        self.wire = _fresh_wire()

    def warmup(self) -> None:
        self.prefill.warmup()
        self.decode.warmup()

    # --- decode-tier delivery callbacks (HandoffSink) ---------------------

    def _import_cb(self, pages: list[int], blobs: list[bytes], meta: dict,
                   record: dict) -> None:
        eng = self.decode
        if (
            meta.get("page_size") != eng.page_size
            or meta.get("kv_dtype") != eng.kv_dtype
            or meta.get("eos_id") != eng.eos_id
        ):
            # adopting these pages would decode garbage or diverge the
            # token stream; a raise here makes the sink degrade to
            # re-prefill (which is geometry-independent)
            raise ValueError(
                f"handoff meta {meta} does not match decode engine "
                f"(page_size={eng.page_size}, kv_dtype={eng.kv_dtype}, "
                f"eos_id={eng.eos_id})"
            )
        row = record["request"]
        t0 = time.perf_counter()
        host = [decode_page(b) for b in blobs]
        t1 = time.perf_counter()
        eng.import_kv_pages(pages, host)
        _sync(eng)
        self.wire["decode_s"] += t1 - t0
        self.wire["h2d_s"] += time.perf_counter() - t1
        eng.seed_handoff_import(
            int(row["rid"]),
            pages=pages,
            pos=int(meta["pos"]),
            last=int(row["tokens"][-1]),
            prompt=row["prompt"],
        )
        self._deliveries[int(row["rid"])] = {"mode": "imported", "row": row}

    def _reprefill_cb(self, record: dict) -> None:
        row = record["request"]
        self._deliveries[int(row["rid"])] = {"mode": "reprefill", "row": row}

    def _on_export(self, export: dict) -> None:
        rid = int(export["request"]["rid"])
        hid = f"{self._node}-g{self._gen}-r{rid}"
        self._exports[rid] = {
            "first_token_tick": int(export["first_token_tick"]),
            "n_pages": len(export["pages"]),
        }
        t0 = time.perf_counter()
        plan = build_handoff_plan(export, hid)
        t1 = time.perf_counter()
        outcome = self.mover.execute(plan)
        self.wire["fetch_s"] += export.get("fetch_s", 0.0)
        self.wire["encode_s"] += t1 - t0
        self.wire["mover_s"] += time.perf_counter() - t1
        self.wire["pages"] += len(plan.pages)
        self.wire["bytes"] += sum(len(p) for p in plan.pages)
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1

    # --- the two-tier co-simulation ---------------------------------------

    def serve(
        self,
        requests: Sequence[Request],
        *,
        prefill_down: bool = False,
    ) -> dict:
        """Serve ``requests`` across both tiers and return the combined
        per-request view::

            {
              "results": {rid: {"tokens", "ttft_ticks", "tpot_ticks",
                                "path"}},   # path: prefill|handoff|
                                            #   reprefill|prefill_down
              "outcomes": {...},  # mover outcomes this serve
              "dropped": [...],   # rids that never produced tokens
              "prefill": ServeStats | None, "decode": ServeStats,
              "peer": the peer client's doc,
            }

        ``prefill_down=True`` models a prefill-tier outage: every request
        is submitted raw to the decode tier (full local prefill), the
        degradation ladder's floor.
        """
        self._gen += 1
        self._exports = {}
        self._deliveries = {}
        self.outcomes = {}
        self.wire = _fresh_wire()
        if prefill_down:
            dstats = self.decode.run(list(requests))
            results = {
                r.rid: self._entry(r, r.arrival_tick, "prefill_down")
                for r in dstats.results
            }
            return self._finish(requests, results, None, dstats)
        self.prefill.set_handoff_sink(self._on_export)
        try:
            pstats = self.prefill.run(list(requests))
        finally:
            self.prefill.set_handoff_sink(None)
        self.ledger.publish(self._registry, self._pod)
        by_rid = {r.rid: r for r in requests}
        decode_reqs: list[Request] = []
        seeds: dict[int, list[int]] = {}
        for rid, d in sorted(self._deliveries.items()):
            row = d["row"]
            exp = self._exports.get(rid) or {}
            delay = max(
                1,
                int(math.ceil(exp.get("n_pages", 1) / self._xfer_rate)),
            )
            arrival = float(exp.get("first_token_tick", 0) + delay)
            decode_reqs.append(
                Request(
                    rid=rid,
                    prompt=tuple(int(t) for t in row["prompt"]),
                    max_new=int(row["max_new"]),
                    arrival=arrival,
                    tier=str(row["tier"]),
                    slo_ttft_ticks=row.get("slo_ttft_ticks"),
                    slo_tpot_ticks=row.get("slo_tpot_ticks"),
                    # the tenant's adapter goes with its row (the
                    # reference drops it here: fault 6)
                    adapter_id=str(row.get("adapter_id") or ""),
                )
            )
            # every handed-off request starts from its prefill-tier first
            # token: the import path adopts KV on top of it, the fallback
            # path re-prefills prompt + token
            seeds[rid] = [int(t) for t in row["tokens"]]
        self.decode.seed_restore_tokens(seeds)
        try:
            dstats = self.decode.run(decode_reqs)
        finally:
            self.decode.clear_handoff_seeds()
        results: dict[int, dict] = {}
        for r in pstats.results:
            if r.rid in self._deliveries:
                continue  # handed off; the decode tier's row is the result
            results[r.rid] = self._entry(r, r.arrival_tick, "prefill")
        darr = {q.rid: q.arrival for q in decode_reqs}
        for r in dstats.results:
            d = self._deliveries.get(r.rid)
            path = "handoff" if d and d["mode"] == "imported" else "reprefill"
            entry = self._entry(r, darr.get(r.rid, r.arrival_tick), path)
            exp = self._exports.get(r.rid)
            src = by_rid.get(r.rid)
            if exp is not None and src is not None:
                # end-to-end TTFT reads off the prefill tier's clock
                entry["ttft_ticks"] = (
                    exp["first_token_tick"] - float(src.arrival)
                )
            results[r.rid] = entry
        return self._finish(requests, results, pstats, dstats)

    def _entry(self, res: Any, start_tick: float, path: str) -> dict:
        n = len(res.tokens)
        ttft = (
            res.first_token_tick - float(start_tick)
            if res.first_token_tick is not None else None
        )
        tpot = (
            (res.finish_tick - float(start_tick)) / (n - 1)
            if n > 1 and res.finish_tick is not None else None
        )
        return {
            "tokens": list(res.tokens),
            "ttft_ticks": ttft,
            "tpot_ticks": tpot,
            "path": path,
        }

    def _finish(
        self,
        requests: Sequence[Request],
        results: dict[int, dict],
        pstats: ServeStats | None,
        dstats: ServeStats,
    ) -> dict:
        dropped = [
            r.rid for r in requests
            if r.rid not in results or not results[r.rid]["tokens"]
        ]
        if dropped:
            log.warning("disagg serve dropped rids %s", dropped)
        return {
            "results": results,
            "outcomes": dict(self.outcomes),
            "dropped": dropped,
            "prefill": pstats,
            "decode": dstats,
            "peer": self.peer.doc(),
        }
