"""Table rendering for the inspect CLI.

Counterpart of ``gpushare_device_plugin_tpu/cli/display.py`` (upstream:
``cmd/inspect/display.go``), byte for byte the same output for the same
inputs. Summary: per-node per-card ``used/total`` plus the cluster
utilization total (``display.go:231-241``). Details adds per-pod rows with
card attribution. Also the views of ``top``, ``why``, ``timeline``,
``shards``, ``fleet``, ``trace`` and ``flightrecord``.
"""

from __future__ import annotations

from io import StringIO

from .. import const
from .nodeinfo import PENDING_IDX, NodeInfo, infer_unit


def _table(rows: list[list[str]]) -> str:
    if not rows:
        return ""
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    out = []
    for r in rows:
        out.append("  ".join(cell.ljust(w) for cell, w in zip(r, widths)).rstrip())
    return "\n".join(out)


def _chip_cell(info: NodeInfo, d, held: set[int]) -> str:
    """One chip's ``used/total`` summary, marking exclusive holds and —
    when the node publishes defrag status — stranded slivers (free HBM
    below the defragmenter's quantum)."""
    if d.index in held:
        body = "exclusive"
    else:
        body = f"{d.used_units}/{d.total_units}"
        stranded = info.stranded_by_chip.get(d.index, 0)
        if stranded:
            body += f" ({stranded} stranded)"
    return f"chip{d.index}: {body}"


def _moves_cell(status: dict | None) -> str:
    """The MOVES column: planned/active/completed move counters plus the
    last move's duration, from the defrag-status node annotation."""
    if not status:
        return "-"
    cell = (
        f"{int(status.get('planned', 0))} planned · "
        f"{int(status.get('active', 0))} active · "
        f"{int(status.get('completed', 0))} done"
    )
    last = status.get("last_move_ms")
    if last:
        cell += f" · last {float(last):.1f}ms"
    return cell


def render_summary(infos: list[NodeInfo]) -> str:
    unit = infer_unit(infos)
    buf = StringIO()
    any_core = any(i.core_holds for i in infos)
    any_defrag = any(i.defrag is not None for i in infos)
    header = ["NAME", "IPADDRESS", f"TPU Memory ({unit})"]
    if any_core:
        header.append("EXCLUSIVE CHIPS (tpu-core)")
    if any_defrag:
        header.append("MOVES (defrag)")
    rows = [header]
    for info in infos:
        held = set(info.core_held_chips)
        chips = ", ".join(
            _chip_cell(info, d, held)
            for d in sorted(info.devices.values(), key=lambda d: d.index)
        )
        row = [info.name, info.address, chips]
        if any_core:
            pending_holds = sum(1 for h in info.core_holds if not h.chips)
            cell = ",".join(str(i) for i in info.core_held_chips) or "-"
            if pending_holds:
                cell += f" (+{pending_holds} pending)"
            row.append(cell)
        if any_defrag:
            row.append(_moves_cell(info.defrag))
        rows.append(row)
    buf.write(_table(rows))
    buf.write("\n")
    total = sum(i.total_units for i in infos)
    used = sum(i.used_units for i in infos)
    pct = (100.0 * used / total) if total else 0.0
    buf.write("-" * 40 + "\n")
    buf.write(
        f"Allocated/Total TPU Memory ({unit}) In Cluster:\n{used}/{total} ({pct:.0f}%)\n"
    )
    pending = sum(i.pending_units for i in infos)
    if pending:
        buf.write(f"Pending (unattributed) TPU Memory ({unit}): {pending}\n")
    if any_core:
        n_held = sum(len(i.core_held_chips) for i in infos)
        n_pods = sum(len(i.core_holds) for i in infos)
        buf.write(
            f"Exclusively held TPU chips (tpu-core): {n_held} across {n_pods} pod(s)\n"
        )
    if any_defrag:
        stranded = sum(sum(i.stranded_by_chip.values()) for i in infos)
        buf.write(
            f"Stranded (sub-quantum sliver) TPU Memory ({unit}): {stranded}\n"
        )
    return buf.getvalue()


def _gang_cell(pod, info: NodeInfo, unit: str) -> str:
    """One gang pod's grant, rendered with grid coordinates: e.g.
    ``2x2x1 @ (0,0,0)(1,0,0)(0,1,0)(1,1,0) · 8 GiB/chip``. Falls back to
    bare indices when the node's grid is unknown."""
    members = sorted(i for i in pod.units_by_chip if i != PENDING_IDX)
    if info.topology is not None:
        try:
            coords = "".join(
                "({},{},{})".format(*info.topology.coords(i)) for i in members
            )
        except ValueError:  # annotation points off the grid
            coords = ",".join(f"chip{i}" for i in members)
    else:
        coords = ",".join(f"chip{i}" for i in members)
    return f"{pod.gang_shape} @ {coords} · {pod.gang_per_chip} {unit}/chip"


def _engine_cell(row: dict[str, float]) -> str:
    """One serving pod's cache telemetry as a compact cell: KV page
    occupancy, radix prefix-cache hit ratio, and the preemption count —
    the ``tpushare_engine_*`` families scraped from the pod's
    ``/metrics`` endpoint (``inspect.parse_engine_metrics`` keys, prefix
    already stripped). A disaggregated pod's ``tpushare_handoff_*``
    counters (folded into the row under ``handoff_*`` keys) append the
    KV-handoff story: transfers delivered, re-prefill fallbacks, pages
    still staged in flight. A speculative engine
    (``tpushare_engine_spec_*`` families) appends its summary — draft
    length, mean tokens emitted per verify dispatch, rollback pages —
    e.g. ``spec k=4 · acc 2.7/step · rb 12``; pods that export no spec
    families show nothing extra."""
    parts = []
    total = row.get("kv_pages_total")
    if total is not None:
        used = row.get("kv_pages_used")
        if used is None:
            used = total - row.get("kv_pages_free", 0.0)
        parts.append(f"pages {int(used)}/{int(total)}")
    hit = row.get("prefix_hit_ratio")
    if hit is not None:
        parts.append(f"prefix {100.0 * hit:.0f}%")
    pre = row.get("preemptions_total", row.get("preemptions"))
    if pre is not None:
        parts.append(f"preempt {int(pre)}")
    if any(k.startswith("handoff_") for k in row):
        parts.append(
            f"handoff {int(row.get('handoff_transfers_total_delivered', 0))}"
        )
        reprefill = sum(
            v for k, v in row.items()
            if k.startswith("handoff_fallback_reprefill_total")
        )
        if reprefill:
            parts.append(f"reprefill {int(reprefill)}")
        inflight = row.get("handoff_pages_in_flight", 0.0)
        if inflight:
            parts.append(f"inflight {int(inflight)}")
    if row.get("spec_enabled"):
        spec = f"spec k={int(row.get('spec_k', 0))}"
        cnt = row.get("spec_accepted_tokens_per_step_count", 0.0)
        if cnt:
            mean = row.get("spec_accepted_tokens_per_step_sum", 0.0) / cnt
            spec += f" · acc {mean:.1f}/step"
        spec += f" · rb {int(row.get('spec_rollback_pages_total', 0.0))}"
        parts.append(spec)
    return " · ".join(parts) or "-"


def _adapter_cell(row: dict[str, float] | None) -> str:
    """One multi-LoRA pod's ADAPTERS cell: resident adapters and the
    pool pages they hold, the admission hit ratio, and the eviction
    count — the ``tpushare_engine_adapter_*`` families. "-" when the
    pod's engine serves only the base model."""
    if not row or not row.get("adapter_enabled"):
        return "-"
    parts = [
        f"{int(row.get('adapter_resident', 0.0))} resident",
        f"{int(row.get('adapter_cache_pages', 0.0))} pages",
    ]
    hits = row.get("adapter_hits_total", 0.0)
    misses = row.get("adapter_misses_total", 0.0)
    if hits + misses:
        parts.append(f"hit {100.0 * hits / (hits + misses):.0f}%")
    ev = row.get("adapter_evictions_total", 0.0)
    if ev:
        parts.append(f"evict {int(ev)}")
    return " · ".join(parts)


def adapter_row_for(row: dict[str, float] | None) -> dict | None:
    """The ``adapters`` JSON sub-document for one scraped engine row
    (``-o json``): residency gauges, hit/miss/eviction counters with the
    recovered hit ratio, and the mean adapter-miss stall from the
    histogram's ``_sum``/``_count`` samples. ``None`` when the pod
    exports no adapter families — a base-model-only reference document
    gains no key (the ``speculative`` precedent)."""
    if not row or not row.get("adapter_enabled"):
        return None
    out: dict = {
        "enabled": True,
        "resident": int(row.get("adapter_resident", 0.0)),
        "cache_pages": int(row.get("adapter_cache_pages", 0.0)),
        "hits": int(row.get("adapter_hits_total", 0.0)),
        "misses": int(row.get("adapter_misses_total", 0.0)),
        "evictions": int(row.get("adapter_evictions_total", 0.0)),
    }
    total = out["hits"] + out["misses"]
    if total:
        out["hit_ratio"] = round(out["hits"] / total, 3)
    cnt = row.get("adapter_miss_stall_seconds_count", 0.0)
    if cnt:
        out["miss_stall_mean_s"] = round(
            row.get("adapter_miss_stall_seconds_sum", 0.0) / cnt, 6
        )
    return out


def spec_row_for(row: dict[str, float] | None) -> dict | None:
    """The ``speculative`` JSON sub-document for one scraped engine row
    (``-o json``): draft length, dispatch/rollback counters, and the
    acceptance means recovered from the histograms' ``_sum``/``_count``
    samples. ``None`` when the pod exports no spec families — the
    no-speculation reference document gains no key."""
    if not row or not row.get("spec_enabled"):
        return None
    out: dict = {
        "enabled": True,
        "k": int(row.get("spec_k", 0.0)),
        "draft_steps": int(row.get("spec_draft_steps_total", 0.0)),
        "rollback_pages": int(row.get("spec_rollback_pages_total", 0.0)),
    }
    cnt = row.get("spec_acceptance_len_count", 0.0)
    if cnt:
        out["acceptance_len_mean"] = round(
            row.get("spec_acceptance_len_sum", 0.0) / cnt, 3
        )
    cnt = row.get("spec_accepted_tokens_per_step_count", 0.0)
    if cnt:
        out["accepted_tokens_per_step_mean"] = round(
            row.get("spec_accepted_tokens_per_step_sum", 0.0) / cnt, 3
        )
    return out


def engine_row_for(pod, engine: dict[str, dict[str, float]] | None):
    """The scraped telemetry row for ``pod``, matched by the engine's
    ``pod`` metrics label: ``namespace/name`` first, then the bare pod
    name (what a pod that only knows its own name exports). ``None``
    when the pod runs no serving engine (or none was scraped)."""
    if not engine:
        return None
    return engine.get(f"{pod.namespace}/{pod.name}") or engine.get(pod.name)


def _interference_lines(doc: dict, indent: str = "") -> str:
    """Per-chip interference verdicts (the parsed
    ``tpushare.aliyun.com/interference`` annotation), one line per chip:
    victim, ratio vs its solo baseline, aggressors, FLAGGED marker."""
    def _chip_key(kv):
        # numeric order like every other per-chip listing (chip10 must
        # not sort before chip2); non-numeric keys sort after, by name
        try:
            return (0, int(kv[0]), "")
        except (TypeError, ValueError):
            return (1, 0, str(kv[0]))

    out = []
    for chip, row in sorted((doc.get("chips") or {}).items(), key=_chip_key):
        aggs = ", ".join(row.get("aggressors") or []) or "?"
        flag = "  FLAGGED" if row.get("flagged") else ""
        out.append(
            f"{indent}chip{chip}: {row.get('victim', '?')} "
            f"{row.get('ratio', 0.0):.2f}x vs solo "
            f"(aggressors: {aggs}){flag}\n"
        )
    return "".join(out)


def _fmt_step(row: dict[str, float] | None) -> str:
    """A pod's rolling step p50/p99 cell from its scraped
    ``tpushare_engine_step_p{50,99}_seconds`` gauges; "-" when the pod
    exports no step profile."""
    if not row:
        return "-"
    p50 = row.get("step_p50_seconds")
    p99 = row.get("step_p99_seconds")
    if p50 is None and p99 is None:
        return "-"

    def ms(v):
        return f"{v * 1e3:.1f}ms" if v is not None else "?"

    return f"{ms(p50)}/{ms(p99)}"


def render_top(
    infos: list[NodeInfo],
    obs: dict | None = None,
    *,
    now_label: str = "",
) -> str:
    """One refresh of the ``kubectl-inspect-tpushare top`` live view:
    per-chip co-residency (with workload classes), each resident's
    rolling step p50/p99, the chip's interference verdict, and the
    scraped SLO burn-rate + governor state. Deterministic for a given
    input set (golden-tested like ``render_trace``).

    ``obs`` is ``inspect.fetch_observability_metrics`` output:
    ``{"engine": {pod: {...}}, "slo": {tier: {...}}, "governor":
    {pod: {...}}}`` — any part may be missing (partial scrape)."""
    engine = (obs or {}).get("engine") or {}
    slo = (obs or {}).get("slo") or {}
    governor = (obs or {}).get("governor") or {}
    build = (obs or {}).get("build") or {}
    buf = StringIO()
    title = "tpushare top"
    if now_label:
        title += f" — {now_label}"
    buf.write(title + "\n")
    if build:
        buf.write(f"build: {_fmt_build(build)}\n")
    rows = [["NODE", "CHIP", "RESIDENTS (class)", "STEP p50/p99",
             "INTERFERENCE"]]
    for info in infos:
        held = set(info.core_held_chips)
        idoc = (info.interference or {}).get("chips") or {}
        for d in sorted(info.devices.values(), key=lambda d: d.index):
            residents = [
                p for p in info.pods if d.index in p.units_by_chip
            ]
            if d.index in held:
                res_cell = "exclusive (tpu-core)"
            elif residents:
                res_cell = " ".join(
                    f"{p.namespace}/{p.name}"
                    + ("(BE)" if p.workload_class
                       == const.WORKLOAD_BEST_EFFORT else "(LC)")
                    for p in sorted(
                        residents, key=lambda p: (p.namespace, p.name)
                    )
                )
            else:
                res_cell = "-"
            step_cells = []
            for p in sorted(residents, key=lambda p: (p.namespace, p.name)):
                cell = _fmt_step(engine_row_for(p, engine))
                if cell != "-":
                    step_cells.append(cell)
            irow = idoc.get(str(d.index))
            if irow:
                icell = (
                    f"{irow.get('ratio', 0.0):.2f}x {irow.get('victim', '?')}"
                    + (" FLAGGED" if irow.get("flagged") else "")
                )
            else:
                icell = "-"
            rows.append([
                info.name, f"chip{d.index}", res_cell,
                " ".join(step_cells) or "-", icell,
            ])
    buf.write(_table(rows))
    buf.write("\n")
    if slo:
        buf.write("SLO BURN\n")
        sev_names = {0.0: "ok", 1.0: "warn", 2.0: "page"}
        for tier, row in sorted(slo.items()):
            sev = sev_names.get(row.get("severity", 0.0), "?")
            line = (
                f"  {tier:<12} 5m={row.get('burn_5m', 0.0):.2f} "
                f"1h={row.get('burn_1h', 0.0):.2f} "
                f"6h={row.get('burn_6h', 0.0):.2f}"
            )
            remaining = row.get("error_budget_remaining")
            if remaining is not None:
                line += f" budget={remaining * 100:.1f}%"
            buf.write(f"{line} [{sev}]\n")
    if governor:
        buf.write("GOVERNOR\n")
        for pod, row in sorted(governor.items()):
            engaged = "ENGAGED" if row.get("engaged") else "released"
            buf.write(
                f"  {pod or '(unlabeled)':<20} {engaged} "
                f"engagements={int(row.get('engagements_total', 0))} "
                f"throttled={int(row.get('throttled_steps_total', 0))}\n"
            )
    return buf.getvalue()


def _fmt_build(build: dict | None) -> str:
    """One-line build identity from the scraped ``tpushare_build_info``
    labels: ``daemon v0.1.0 (rev abc123, py 3.10, jax 0.4.37)`` per
    component, joined by ``·``."""
    if not build:
        return ""
    parts = []
    for component, labels in sorted(build.items()):
        parts.append(
            f"{component} v{labels.get('version', '?')} "
            f"(rev {labels.get('git_rev', '?')}, "
            f"py {labels.get('python', '?')}, "
            f"jax {labels.get('jax', '?')})"
        )
    return " · ".join(parts)


def _score_cell(sv: dict) -> str:
    """One ScoreVector dict as a compact breakdown cell: the raw
    full-resolution score, its 0-10 wire projection, and the terms
    behind it (gang records add the topology objective components)."""
    parts = [
        f"raw={sv.get('raw', 0.0):.4f}",
        f"wire={sv.get('projected', 0)}/10",
        f"free={int(sv.get('free_units', 0))}",
        f"req={int(sv.get('request_units', 0))}",
        f"binpack={sv.get('binpack', 0.0):.3f}",
    ]
    for key in ("ici_hops", "stranded", "broken", "tie_break"):
        if key in sv:
            parts.append(f"{key}={sv[key]}")
    return " ".join(parts)


def _placement_cell(placement: dict) -> str:
    parts = []
    if placement.get("group"):
        cell = f"group {placement['group']}"
        if placement.get("members"):
            cell += f" ({placement['members']} members)"
        parts.append(cell)
    if "chip" in placement:
        parts.append(f"chip {placement['chip']}")
    if "chips" in placement:
        parts.append(
            "chips " + ",".join(str(i) for i in placement["chips"])
        )
    if placement.get("shape"):
        parts.append(f"shape {placement['shape']}")
    if "units" in placement:
        parts.append(f"{placement['units']} units")
    if "per_chip" in placement:
        parts.append(f"{placement['per_chip']} units/chip")
    if placement.get("tier"):
        parts.append(f"tier {placement['tier']}")
    if placement.get("tiers"):
        # a disaggregated two-tier slice: the group's composition,
        # prefill first (the catalog order), then anything else by name
        order = {t: i for i, t in enumerate(const.SERVING_TIERS)}
        names = sorted(
            placement["tiers"], key=lambda t: (order.get(t, len(order)), t)
        )
        parts.append(
            "tiers " + " + ".join(
                f"{placement['tiers'][t]} {t}" for t in names
            )
        )
    if placement.get("source"):
        parts.append(f"[{placement['source']}]")
    return " · ".join(parts) or "-"


def render_why(pod: str, records: list[dict]) -> str:
    """Render one pod's decision tree (``kubectl-inspect-tpushare why``):
    every verb's record in order — each rejected node with its reason,
    the score breakdowns ranked best-first by the RAW fractional score
    (winner vs runner-up with the margin the 0-10 wire scale cannot
    resolve), the chosen placement, and the WAL seq / trace id that tie
    the record to the journal and the admission trace.
    Deterministic for a given record set (golden-tested like
    ``render_trace``)."""
    buf = StringIO()
    buf.write(f"pod {pod} — {len(records)} decision record(s)\n")
    if not records:
        buf.write(
            "(no decision records: admitted before provenance, emission "
            "disabled, or the ring already evicted it)\n"
        )
        return buf.getvalue()
    for rec in records:
        verb = rec.get("verb", "?")
        head = f"[#{rec.get('id', '?')}] {verb}"
        if rec.get("shard"):
            head += f" @{rec['shard']}"
        if rec.get("node"):
            head += f" -> {rec['node']}"
        if rec.get("outcome", "ok") != "ok":
            head += "  FAILED"
        buf.write(head + "\n")
        if rec.get("reason"):
            buf.write(f"   reason: {rec['reason']}\n")
        degraded = rec.get("degraded_shards") or []
        if degraded:
            # "not consulted" is a different fact than "rejected": these
            # shards' nodes were never scored at all
            buf.write(
                f"   ! not consulted (degraded shards): "
                f"{', '.join(degraded)}\n"
            )
        if rec.get("candidates"):
            line = f"   candidates: {rec['candidates']}"
            if rec.get("rejected"):
                line += f" ({len(rec['rejected'])} rejected)"
            buf.write(line + "\n")
        for node, why in sorted((rec.get("rejected") or {}).items()):
            buf.write(f"   x {node}: {why}\n")
        scores = rec.get("scores") or {}
        ranked = sorted(
            scores.items(),
            key=lambda kv: (-float(kv[1].get("raw", 0.0)), kv[0]),
        )
        for i, (name, sv) in enumerate(ranked):
            tag = "> " if i == 0 else "  "
            buf.write(f"   {tag}{name}  {_score_cell(sv)}\n")
        if len(ranked) >= 2:
            margin = float(ranked[0][1].get("raw", 0.0)) - float(
                ranked[1][1].get("raw", 0.0)
            )
            buf.write(
                f"   margin: {ranked[0][0]} leads {ranked[1][0]} by "
                f"{margin:.4f} raw\n"
            )
        if rec.get("placement"):
            buf.write(f"   placement: {_placement_cell(rec['placement'])}\n")
        moves = rec.get("moves") or []
        if moves:
            buf.write(f"   moves: {', '.join(moves)}\n")
        tail = []
        if rec.get("seq") is not None:
            tail.append(f"wal seq {rec['seq']}")
        if rec.get("trace_id"):
            tail.append(f"trace {rec['trace_id']}")
        if tail:
            buf.write(f"   {' · '.join(tail)}\n")
    return buf.getvalue()


SPARK_LEVELS = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 48) -> str:
    """A unicode sparkline over the LAST ``width`` values, scaled to the
    rendered window's min/max (a flat series renders mid-level)."""
    if not values:
        return ""
    window = values[-width:]
    lo, hi = min(window), max(window)
    if hi - lo < 1e-12:
        return SPARK_LEVELS[3] * len(window)
    out = []
    for v in window:
        i = int((v - lo) / (hi - lo) * (len(SPARK_LEVELS) - 1))
        out.append(SPARK_LEVELS[max(0, min(len(SPARK_LEVELS) - 1, i))])
    return "".join(out)


def render_timeline(doc: dict, width: int = 48) -> str:
    """Render a ``/timeline`` document (``utils.timeline.to_doc``) as
    per-field sparklines with last/min/max annotations. Deterministic
    for a given document (golden-tested)."""
    series = (doc or {}).get("series") or {}
    buf = StringIO()
    buf.write(
        f"cluster timeline — bucket {doc.get('bucket_s', '?')}s, "
        f"span {doc.get('span_s', '?')}s\n"
    )
    populated = {
        # stats cover the SAME trailing window the sparkline renders —
        # a spike older than `width` buckets must not print a max= the
        # glyphs never show
        name: [float(v) for _t, v in points][-width:]
        for name, points in sorted(series.items())
        if points
    }
    if not populated:
        buf.write("(no samples yet)\n")
        return buf.getvalue()
    name_w = max(len(n) for n in populated)
    for name, values in populated.items():
        buf.write(
            f"{name.ljust(name_w)}  {sparkline(values, width=width)}  "
            f"last={values[-1]:g} min={min(values):g} "
            f"max={max(values):g} n={len(values)}\n"
        )
    return buf.getvalue()


def render_shards(doc: dict) -> str:
    """Render a ``/shards`` document (``ShardRouter.shards_doc``): the
    hash-ring ownership spread, one row per shard with its node count,
    WAL seq, journal queue depth, and in-flight 2PC gangs, then the
    pending gang2pc entries. Deterministic for a given document
    (golden-tested like ``render_why``/``render_top``)."""
    buf = StringIO()
    ring = (doc or {}).get("ring") or {}
    rows = (doc or {}).get("shards") or []
    buf.write(
        f"shard map — {ring.get('shards', len(rows))} shard(s), "
        f"{ring.get('vnodes', '?')} vnodes/shard, "
        f"fanout {doc.get('fanout', '?')}\n"
    )
    if not rows:
        buf.write("(no shards)\n")
        return buf.getvalue()
    per = ring.get("nodes_per_shard") or {}
    name_w = max(len(str(r.get("shard", "?"))) for r in rows)
    header = (
        f"{'SHARD'.ljust(name_w)}  NODES  WAL-SEQ  QUEUE  2PC  STATE"
    )
    buf.write(header + "\n")
    for r in rows:
        sid = str(r.get("shard", "?"))
        nodes = r.get("nodes", per.get(sid, 0))
        state = "PARTITIONED" if r.get("partitioned") else "ok"
        buf.write(
            f"{sid.ljust(name_w)}  {str(nodes).rjust(5)}  "
            f"{str(r.get('wal_seq', 0)).rjust(7)}  "
            f"{str(r.get('wal_pending', 0)).rjust(5)}  "
            f"{str(r.get('gangs_inflight', 0)).rjust(3)}  {state}\n"
        )
    gangs = (doc or {}).get("gangs_2pc") or []
    if gangs:
        buf.write("gang 2PC in flight:\n")
        for g in sorted(
            gangs, key=lambda g: (g.get("group", ""), g.get("pod", ""))
        ):
            buf.write(
                f"   {g.get('group', '?')} [{g.get('phase', '?')}] "
                f"pod={g.get('pod', '') or '-'} "
                f"node={g.get('node', '') or '-'} "
                f"shard={g.get('shard', '?')}\n"
            )
    return buf.getvalue()


def render_fleet(doc: dict) -> str:
    """Render a ``/fleet`` document (``FleetServer.fleet_doc``): one
    row per replica with its lifecycle state, health (consecutive
    scrape misses), headroom, queue depth and fingerprint count, then
    the router's routing/shed outcomes and the scale-down drain status.
    Deterministic for a given document (golden-tested like
    ``render_shards``)."""
    buf = StringIO()
    replicas = (doc or {}).get("replicas") or {}
    router = (doc or {}).get("router") or {}
    scale = (doc or {}).get("scale") or {}
    ratio = (doc or {}).get("prefix_hit_ratio")
    buf.write(
        f"fleet — {len(replicas)} replica(s), policy "
        f"{router.get('policy', '?')}, global prefix-hit ratio "
        f"{ratio if ratio is not None else '?'}\n"
    )
    if not replicas:
        buf.write("(no replicas)\n")
        return buf.getvalue()
    name_w = max(len("REPLICA"), max(len(str(n)) for n in replicas))
    header = (
        f"{'REPLICA'.ljust(name_w)}  STATE      MISSES  FREE  CAP  "
        f"QUEUE  PREFIXES"
    )
    buf.write(header + "\n")
    for name in sorted(replicas):
        r = replicas[name] or {}
        buf.write(
            f"{str(name).ljust(name_w)}  "
            f"{str(r.get('state', '?')).ljust(9)}  "
            f"{str(r.get('misses', 0)).rjust(6)}  "
            f"{str(r.get('free_slots', 0)).rjust(4)}  "
            f"{str(r.get('capacity', 0)).rjust(3)}  "
            f"{str(r.get('queue_depth', 0)).rjust(5)}  "
            f"{str(r.get('fingerprints', 0)).rjust(8)}\n"
        )
    outcomes = router.get("outcomes") or {}
    if outcomes:
        parts = [f"{k}={outcomes[k]}" for k in sorted(outcomes)]
        buf.write(
            f"router: {' '.join(parts)} "
            f"inflight={router.get('inflight', 0)} "
            f"affinity_hit_ratio="
            f"{round(router.get('affinity_hit_ratio', 0.0) or 0.0, 4)}\n"
        )
    buf.write(
        f"scale: ops={scale.get('ops', 0)} "
        f"migrated_requests={scale.get('migrated_requests', 0)}\n"
    )
    return buf.getvalue()


def render_trace(spans: list[dict]) -> str:
    """Render one admission/serving trace as an offset/duration tree.

    ``spans`` are flat span dicts (``utils.tracing.spans_from_otlp`` /
    ``Span.to_dict``); offsets are milliseconds from the earliest span's
    start. Orphans (parent span not in the set — e.g. only one process's
    ``/traces`` endpoint was reachable) render as extra roots, so a
    partial fetch still shows a timeline. Deterministic for a given span
    set (golden-tested)."""
    if not spans:
        return "(no spans)\n"
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    children: dict[str, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        parent = s.get("parent_id", "")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    t0 = min(s["start_ns"] for s in spans)
    buf = StringIO()
    trace_ids = sorted({s.get("trace_id", "") for s in spans})
    buf.write(f"trace {', '.join(t for t in trace_ids if t)}\n")

    def attr_note(s: dict) -> str:
        attrs = s.get("attributes") or {}
        parts = []
        for key in ("pod", "node", "chip", "chips", "rid", "error"):
            if key in attrs:
                parts.append(f"{key}={attrs[key]}")
        if s.get("status") not in (None, "ok"):
            parts.append(f"status={s['status']}")
        return ("  " + " ".join(parts)) if parts else ""

    def emit(s: dict, prefix: str, tail: str, child_prefix: str) -> None:
        start_ms = (s["start_ns"] - t0) / 1e6
        dur_ms = max(0, s.get("end_ns", 0) - s["start_ns"]) / 1e6
        name = f"{prefix}{tail}{s.get('name', '?')}"
        buf.write(
            f"{name:<44} +{start_ms:9.3f}ms {dur_ms:9.3f}ms{attr_note(s)}\n"
        )
        kids = sorted(
            children.get(s.get("span_id", ""), ()),
            key=lambda c: (c["start_ns"], c.get("name", "")),
        )
        for i, kid in enumerate(kids):
            last = i == len(kids) - 1
            emit(
                kid,
                prefix + child_prefix,
                "└─ " if last else "├─ ",
                "   " if last else "│  ",
            )

    for root in sorted(roots, key=lambda s: (s["start_ns"], s.get("name", ""))):
        emit(root, "", "", "")
    return buf.getvalue()


def render_flightrecord(doc: dict, max_traces: int = 5, max_logs: int = 20) -> str:
    """Human summary of a flight-record dump (utils/flightrec.py): the
    header, the most recent traces as timeline trees, and the tail of
    the log ring with trace correlation."""
    import datetime

    from ..utils.tracing import spans_from_otlp

    buf = StringIO()
    when = datetime.datetime.fromtimestamp(
        doc.get("time_unix", 0), tz=datetime.timezone.utc
    ).strftime("%Y-%m-%d %H:%M:%S UTC")
    buf.write(f"flight record: reason={doc.get('reason', '?')}\n")
    buf.write(f"captured     : {when} (pid {doc.get('pid', '?')})\n")
    buf.write(
        f"traces       : {doc.get('trace_count', 0)} retained, "
        f"{doc.get('dropped_traces', 0)} older evicted\n"
    )
    timeline = doc.get("timeline") or {}
    tl_series = {
        k: v for k, v in (timeline.get("series") or {}).items() if v
    }
    if tl_series:
        buf.write(
            f"timeline     : {len(tl_series)} series over the last "
            f"{timeline.get('span_s', '?')}s (render with "
            "`inspect timeline`)\n"
        )
        buf.write(render_timeline(timeline))
    spans = spans_from_otlp(doc.get("traces") or {})
    by_trace: dict[str, list[dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    # newest last in store order; show the most recent max_traces
    shown = list(by_trace.items())[-max_traces:]
    if len(by_trace) > len(shown):
        buf.write(f"(showing the last {len(shown)} of {len(by_trace)} traces)\n")
    for _tid, tspans in shown:
        buf.write("\n")
        buf.write(render_trace(tspans))
    logs = doc.get("logs") or []
    if logs:
        buf.write(f"\nlast {min(max_logs, len(logs))} log records:\n")
        for entry in logs[-max_logs:]:
            trace = (
                f" [{entry['trace_id'][:8]}/{entry['span_id'][:8]}]"
                if entry.get("trace_id")
                else ""
            )
            buf.write(
                f"  {entry.get('level', '?'):<8} {entry.get('logger', '?')}"
                f"{trace} {entry.get('message', '')}\n"
            )
    return buf.getvalue()


def render_details(
    infos: list[NodeInfo],
    engine: dict[str, dict[str, float]] | None = None,
    build: dict | None = None,
) -> str:
    unit = infer_unit(infos)
    buf = StringIO()
    if build:
        buf.write(f"build: {_fmt_build(build)}\n")
    for info in infos:
        buf.write(f"NAME: {info.name} ({info.address})\n")
        any_gang = any(p.is_gang for p in info.pods)
        any_engine = engine is not None and any(
            engine_row_for(p, engine) for p in info.pods
        )
        # the ADAPTERS column appears only when some pod's engine serves
        # LoRA tenants — base-model fleets keep the reference layout
        any_adapter = engine is not None and any(
            (engine_row_for(p, engine) or {}).get("adapter_enabled")
            for p in info.pods
        )
        # the CLASS column appears only when a non-default class is
        # present, preserving the reference layout for fleets that never
        # declare workload classes
        any_class = any(
            p.workload_class != const.WORKLOAD_LATENCY_CRITICAL
            for p in info.pods
        )
        # likewise the TIER column: only when some pod declares a
        # disaggregated-serving tier (serving/handoff.py) — unified
        # fleets keep the reference layout
        any_tier = any(p.serving_tier for p in info.pods)
        header = ["NAMESPACE", "NAME", f"TPU MEMORY ({unit})", "CHIPS"]
        if any_class:
            header.append("CLASS")
        if any_tier:
            header.append("TIER")
        if any_gang:
            header.append("GANG (shape @ coords)")
        if any_engine:
            header.append("SERVING CACHE")
        if any_adapter:
            header.append("ADAPTERS")
        rows = [header]
        for pod in sorted(info.pods, key=lambda p: (p.namespace, p.name)):
            chips = ", ".join(
                ("pending" if idx == PENDING_IDX else f"chip{idx}") + f":{units}"
                for idx, units in sorted(pod.units_by_chip.items())
            )
            row = [pod.namespace, pod.name, str(pod.total_units), chips]
            if any_class:
                row.append(pod.workload_class)
            if any_tier:
                row.append(pod.serving_tier or "-")
            if any_gang:
                row.append(_gang_cell(pod, info, unit) if pod.is_gang else "-")
            if any_engine:
                erow = engine_row_for(pod, engine)
                row.append(_engine_cell(erow) if erow else "-")
            if any_adapter:
                row.append(_adapter_cell(engine_row_for(pod, engine)))
            rows.append(row)
        buf.write(_table(rows))
        buf.write("\n")
        if info.core_holds:
            crows = [["NAMESPACE", "NAME", "EXCLUSIVE CHIPS"]]
            for hold in sorted(info.core_holds, key=lambda h: (h.namespace, h.name)):
                chips = ",".join(f"chip{i}" for i in hold.chips) or (
                    f"pending ({hold.requested} chip"
                    + ("s" if hold.requested != 1 else "")
                    + ")"
                )
                crows.append([hold.namespace, hold.name, chips])
            buf.write(_table(crows))
            buf.write("\n")
        buf.write(
            f"Allocated : {info.used_units} ({(100.0 * info.used_units / info.total_units) if info.total_units else 0:.0f}%)\n"
        )
        buf.write(f"Total     : {info.total_units}\n")
        if info.defrag is not None:
            slivers = " ".join(
                f"chip{i}:{u}"
                for i, u in sorted(info.stranded_by_chip.items())
            ) or "none"
            buf.write(
                f"Stranded  : {sum(info.stranded_by_chip.values())} "
                f"({unit}, sub-quantum slivers: {slivers}, "
                f"quantum {int(info.defrag.get('quantum') or 0)})\n"
            )
            buf.write(f"Moves     : {_moves_cell(info.defrag)}\n")
        if info.interference and info.interference.get("chips"):
            buf.write(
                "Interference:\n"
                + _interference_lines(info.interference, indent="  ")
            )
        buf.write("\n")
    buf.write(render_summary(infos))
    return buf.getvalue()
