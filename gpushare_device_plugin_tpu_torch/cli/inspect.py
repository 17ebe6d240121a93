"""``kubectl-inspect-gpushare-cuda``: the cluster's share-utilization
report, admission-trace timelines and flight-record postmortems.

Counterpart of ``gpushare_device_plugin_tpu/cli/inspect.py`` (upstream:
``cmd/inspect/main.go:31-74``): the same views, rendered byte for byte as
the reference renders them. An optional node-name argument narrows the
report; ``-d`` shows per-pod details. It reads the apiserver (kubeconfig
from ``$KUBECONFIG``/``~/.kube/config``, JSON needing nothing beyond the
standard library, else in-cluster) with the upstream CLI's 5 x 100 ms list
retry budget (``podinfo.go:24,64-69``), and every HTTP endpoint through
``urllib``: it imports neither torch nor any third-party HTTP library.

Subcommands:

- ``trace [ns/]pod --traces-url http://node:PORT [...]``: the pod's
  ``tpushare.aliyun.com/trace-id`` annotation, the trace fetched from each
  ``/traces`` endpoint, merged, as an admission timeline.
- ``why [ns/]pod --decisions-url URL [...]``: the pod's decision records
  from each ``/decisions`` endpoint, merged into one decision tree.
- ``timeline --timeline-url URL [...]``: the cluster-state timeline ring
  (utilization, stranded %, queue depth, SLO burn) as sparklines.
- ``top [node] --metrics-url URL [...]``: per-card co-residency, step
  p50/p99, interference verdicts and SLO burn, refreshed.
- ``shards --shards-url URL`` and ``fleet --fleet-url URL``: the sharded
  extender's shard map and the fleet router's replica map.
- ``flightrecord <file>``: a flight-recorder dump, summarized.
"""

from __future__ import annotations

import argparse
import json
import sys

from .. import const
from ..cluster.apiserver import ApiServerClient
from ..utils.metric_catalog import (
    BUILD_INFO,
    PREFIX_ENGINE,
    PREFIX_FLEET,
    PREFIX_GOVERNOR,
    PREFIX_HANDOFF,
    PREFIX_ROUTER,
    PREFIX_SLO,
)
from ..utils.retry import retry
from .display import (
    render_details,
    render_flightrecord,
    render_summary,
    render_trace,
)
from .nodeinfo import build_all_node_infos

LIST_RETRIES = 5
LIST_DELAY_S = 0.1


def _client(timeout_s: float = 10.0) -> ApiServerClient:
    return ApiServerClient.from_env(timeout_s=timeout_s)


def gather(client: ApiServerClient, node_name: str = "") -> tuple[list, list]:
    nodes = retry(client.list_nodes, attempts=LIST_RETRIES, delay_s=LIST_DELAY_S)
    if node_name:
        nodes = [n for n in nodes if n.get("metadata", {}).get("name") == node_name]
        if not nodes:
            raise SystemExit(f"error: node {node_name!r} not found")
    pods = retry(client.list_pods, attempts=LIST_RETRIES, delay_s=LIST_DELAY_S)
    return nodes, pods


def _http_get(url: str, params: dict | None = None, timeout_s: float = 10.0) -> str:
    """GET ``url``, with ``params`` as its query, and return the body text.
    Raises on a transport error or a status that is not 2xx."""
    import urllib.parse
    import urllib.request

    if params:
        url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", "replace")


def _fetch_json_docs(urls: list[str], suffix: str, params=None):
    """Yield one parsed JSON document per reachable endpoint — THE
    fetch-and-merge boilerplate (URL suffix normalization, 10 s timeout,
    warn-on-stderr partial-merge policy) shared by every JSON endpoint
    reader (``/traces``, ``/decisions``, ``/timeline``); a partial
    answer beats none."""
    for url in urls:
        full = url.rstrip("/")
        if not full.endswith(suffix):
            full += suffix
        try:
            yield json.loads(_http_get(full, params))
        except Exception as e:  # noqa: BLE001 — partial merge by design
            print(f"warning: {full} unreachable: {e}", file=sys.stderr)


def fetch_trace_spans(urls: list[str], trace_id: str) -> list[dict]:
    """Fetch + merge one trace from every ``/traces`` endpoint given
    (extender and node daemon each hold their process's half; spans are
    deduped by span id). Unreachable endpoints are reported but do not
    fail the merge — a partial timeline beats none."""
    from ..utils.tracing import spans_from_otlp

    spans: dict[str, dict] = {}
    for doc in _fetch_json_docs(urls, "/traces", {"trace_id": trace_id}):
        for span in spans_from_otlp(doc):
            spans.setdefault(span["span_id"], span)
    return sorted(spans.values(), key=lambda s: (s["start_ns"], s["name"]))


def parse_engine_metrics(text: str) -> dict[str, dict[str, float]]:
    """Pull the serving engine's cache telemetry out of a ``/metrics``
    exposition: ``tpushare_engine_*`` samples keyed by their ``pod``
    label (``""`` for unlabeled engines). Families: KV page occupancy
    (``kv_pages_total/used/free``), ``prefix_hit_ratio``,
    ``prefix_cached_pages``, the ``preemptions`` gauge /
    ``preemptions_total`` counter, and the speculative-decoding
    ``spec_*`` group (``spec_enabled``/``spec_k`` gauges,
    ``spec_draft_steps_total``/``spec_rollback_pages_total`` counters,
    plus the ``_sum``/``_count`` of the acceptance histograms), and the
    multi-LoRA ``adapter_*`` group (``adapter_enabled``/``resident``/
    ``cache_pages`` gauges, hit/miss/eviction counters, plus the
    ``_sum``/``_count`` of the miss-stall histogram).

    The disaggregated-serving ``tpushare_handoff_*`` families
    (utils/metric_catalog.py) fold into the same per-pod row under
    ``handoff_*`` keys — an ``outcome``/``reason`` label folds into the
    key (``handoff_transfers_total_delivered``); the fleet router's
    ``tpushare_fleet_*`` / ``tpushare_router_*`` families fold the same
    way under ``fleet_*`` / ``router_*`` keys (``engine``/``tier``/
    ``state`` labels fold too: ``router_shed_total_best_effort``,
    ``fleet_replicas_ready``); histogram buckets are skipped, the
    ``_sum``/``_count`` samples carry what the CLI shows."""
    out: dict[str, dict[str, float]] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if line.startswith(PREFIX_ENGINE):
            prefix, fold = PREFIX_ENGINE, ""
        elif line.startswith(PREFIX_HANDOFF):
            prefix, fold = PREFIX_HANDOFF, "handoff_"
        elif line.startswith(PREFIX_FLEET):
            prefix, fold = PREFIX_FLEET, "fleet_"
        elif line.startswith(PREFIX_ROUTER):
            prefix, fold = PREFIX_ROUTER, "router_"
        else:
            continue
        try:
            metric, value = line.rsplit(None, 1)
            val = float(value)
        except ValueError:
            continue
        pod = ""
        name = metric
        labels: dict[str, str] = {}
        if "{" in metric:
            name, raw = metric.split("{", 1)
            labels = _parse_prom_labels(raw.rstrip("}"))
            pod = labels.get("pod", "")
        if name.endswith("_bucket") or "le" in labels:
            continue
        short = fold + name[len(prefix):]
        for extra in ("outcome", "reason", "tier", "state", "engine"):
            if labels.get(extra):
                short += f"_{labels[extra]}"
        out.setdefault(pod, {})[short] = val
    return out


def _parse_prom_labels(raw: str) -> dict[str, str]:
    """Minimal label-block parse ('k="v",k2="v2"'); same tolerance as
    ``parse_engine_metrics`` (label values containing commas are beyond
    this CLI's needs)."""
    out: dict[str, str] = {}
    for part in raw.split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip().strip('"').replace('\\"', '"')
    return out


def parse_observability_metrics(text: str) -> dict:
    """Pull the interference plane's families out of a ``/metrics``
    exposition for the ``top`` view:

    - ``engine``: :func:`parse_engine_metrics` rows (now including the
      ``step_p50_seconds``/``step_p99_seconds`` profiler gauges), keyed
      by ``pod`` label;
    - ``slo``: per-tier burn rates / budget remaining / severity from
      the ``tpushare_slo_*`` gauges;
    - ``governor``: per-pod engage state + counters from the
      ``tpushare_governor_*`` families;
    - ``build``: per-component version labels from
      ``tpushare_build_info`` (the inspect header line).
    """
    out: dict = {
        "engine": parse_engine_metrics(text), "slo": {}, "governor": {},
        "build": {},
    }
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if not line.startswith(
            (PREFIX_SLO, PREFIX_GOVERNOR, BUILD_INFO)
        ):
            continue
        try:
            metric, value = line.rsplit(None, 1)
            val = float(value)
        except ValueError:
            continue
        labels: dict[str, str] = {}
        name = metric
        if "{" in metric:
            name, raw = metric.split("{", 1)
            labels = _parse_prom_labels(raw.rstrip("}"))
        if name == BUILD_INFO:
            component = labels.pop("component", "") or "?"
            out["build"][component] = labels
        elif name.startswith(PREFIX_SLO):
            tier = labels.get("tier", "")
            if not tier:
                continue
            row = out["slo"].setdefault(tier, {})
            short = name[len(PREFIX_SLO):]
            if short == "burn_rate":
                row[f"burn_{labels.get('window', '?')}"] = val
            else:
                row[short] = val
        else:
            pod = labels.get("pod", "")
            row = out["governor"].setdefault(pod, {})
            row[name[len(PREFIX_GOVERNOR):]] = val
    return out


def fetch_observability_metrics(urls: list[str]) -> dict:
    """Scrape + merge the ``top`` view's telemetry from every
    ``/metrics`` endpoint given (same partial-scrape policy as
    :func:`fetch_engine_metrics`)."""
    out: dict = {"engine": {}, "slo": {}, "governor": {}, "build": {}}
    for url in urls:
        full = url.rstrip("/")
        if not full.endswith("/metrics"):
            full += "/metrics"
        try:
            text = _http_get(full)
        except Exception as e:  # noqa: BLE001 — partial scrape by design
            print(f"warning: {full} unreachable: {e}", file=sys.stderr)
            continue
        parsed = parse_observability_metrics(text)
        for section in ("engine", "slo", "governor", "build"):
            for key, row in parsed[section].items():
                out[section].setdefault(key, {}).update(row)
    return out


def fetch_engine_metrics(urls: list[str]) -> dict[str, dict[str, float]]:
    """Scrape serving-cache telemetry from every ``/metrics`` endpoint
    given (each serving pod's engine exports under its own ``pod``
    label). Unreachable endpoints warn but do not fail — partial
    telemetry beats none (same policy as :func:`fetch_trace_spans`)."""
    out: dict[str, dict[str, float]] = {}
    for url in urls:
        full = url.rstrip("/")
        if not full.endswith("/metrics"):
            full += "/metrics"
        try:
            text = _http_get(full)
        except Exception as e:  # noqa: BLE001 — partial scrape by design
            print(f"warning: {full} unreachable: {e}", file=sys.stderr)
            continue
        for pod, row in parse_engine_metrics(text).items():
            out.setdefault(pod, {}).update(row)
    return out


def fetch_decisions(urls: list[str], pod: str) -> list[dict]:
    """Fetch + merge one pod's decision records from every
    ``/decisions`` endpoint given (the extender's and the node daemon's
    metrics ports each hold their process's half of the admission
    story). Records are deduped by (verb, id, time) — ids are
    per-process — and ordered by emission time. Unreachable endpoints
    warn but do not fail: a partial "why" beats none (same policy as
    :func:`fetch_trace_spans`)."""
    merged: dict[tuple, dict] = {}
    for doc in _fetch_json_docs(urls, "/decisions", {"pod": pod}):
        for rec in doc.get("records") or []:
            key = (rec.get("verb"), rec.get("id"), rec.get("time_unix"))
            merged.setdefault(key, rec)
    return sorted(
        merged.values(),
        key=lambda r: (r.get("time_unix", 0.0), r.get("id", 0)),
    )


def why_main(argv: list[str]) -> int:
    """``kubectl-inspect-gpushare-cuda why [ns/]pod``: render the pod's full
    admission decision tree — every rejected node with its reason, the
    score breakdowns (winner vs runner-up at raw resolution), the chosen
    placement, WAL seq, and the stitched trace id."""
    from .display import render_why

    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda why",
        description="Explain one pod's admission decisions",
    )
    p.add_argument("pod", help="[namespace/]name of a share pod")
    p.add_argument("--decisions-url", action="append", default=[],
                   metavar="URL",
                   help="a /decisions endpoint to fetch records from "
                   "(the extender's and/or node daemon's --metrics-"
                   "port); repeatable — records from all endpoints are "
                   "merged into one story")
    p.add_argument("-o", "--output", default="tree", choices=["tree", "json"])
    args = p.parse_args(argv)
    ns, _, name = args.pod.rpartition("/")
    pod_key = f"{ns or 'default'}/{name}"
    if not args.decisions_url:
        print(
            "error: no --decisions-url given — point me at the "
            "extender's and/or node daemon's metrics port (e.g. "
            "--decisions-url http://node:9114)",
            file=sys.stderr,
        )
        return 1
    records = fetch_decisions(args.decisions_url, pod_key)
    if args.output == "json":
        json.dump(records, sys.stdout, indent=2)
        print()
        return 0
    if not records:
        print(
            f"error: no decision records for {pod_key} (admitted before "
            "provenance, emission disabled, or the ring already evicted "
            "it)",
            file=sys.stderr,
        )
        return 1
    sys.stdout.write(render_why(pod_key, records))
    return 0


def fetch_timeline(urls: list[str]) -> dict:
    """Fetch + merge ``/timeline`` documents (per-field union; the same
    field from several endpoints merges by bucket time, later endpoints
    winning ties). Unreachable endpoints warn but do not fail."""
    merged: dict = {"bucket_s": None, "span_s": None, "series": {}}
    for doc in _fetch_json_docs(urls, "/timeline"):
        if merged["bucket_s"] is None:
            merged["bucket_s"] = doc.get("bucket_s")
            merged["span_s"] = doc.get("span_s")
        for field, points in (doc.get("series") or {}).items():
            byt = {t: v for t, v in merged["series"].get(field, [])}
            byt.update({t: v for t, v in points})
            merged["series"][field] = [
                [t, byt[t]] for t in sorted(byt)
            ]
    return merged


def timeline_main(argv: list[str]) -> int:
    """``kubectl-inspect-gpushare-cuda timeline``: sparkline view of the
    cluster-state timeline ring (utilization, stranded %, pending/gang
    queue depth, SLO burn) served on ``/timeline``."""
    from .display import render_timeline

    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda timeline",
        description="Cluster-state timeline sparklines",
    )
    p.add_argument("--timeline-url", action="append", default=[],
                   metavar="URL",
                   help="a /timeline endpoint (a daemon's --metrics-"
                   "port); repeatable — series are merged")
    p.add_argument("--width", type=int, default=48,
                   help="sparkline width in buckets")
    p.add_argument("-o", "--output", default="spark",
                   choices=["spark", "json"])
    args = p.parse_args(argv)
    if not args.timeline_url:
        print(
            "error: no --timeline-url given — point me at a node "
            "daemon's metrics port (e.g. --timeline-url "
            "http://node:9114)",
            file=sys.stderr,
        )
        return 1
    doc = fetch_timeline(args.timeline_url)
    if args.output == "json":
        json.dump(doc, sys.stdout, indent=2)
        print()
        return 0
    sys.stdout.write(render_timeline(doc, width=args.width))
    return 0


def fetch_shards(urls: list[str]) -> dict:
    """Fetch + merge ``/shards`` documents (several router replicas
    serve the same ring; rows merge by shard id, later endpoints
    winning ties). Unreachable endpoints warn but do not fail."""
    merged: dict = {"ring": None, "fanout": None, "shards": {}, "gangs": {}}
    for doc in _fetch_json_docs(urls, "/shards"):
        if merged["ring"] is None:
            merged["ring"] = doc.get("ring")
            merged["fanout"] = doc.get("fanout")
        for row in doc.get("shards") or []:
            merged["shards"][row.get("shard", "?")] = row
        for g in doc.get("gangs_2pc") or []:
            # replicas fronting the same shards report the same gangs —
            # dedupe like the shard rows, not extend
            key = (g.get("group"), g.get("pod"), g.get("shard"),
                   g.get("phase"))
            merged["gangs"].setdefault(key, g)
    return {
        "ring": merged["ring"] or {},
        "fanout": merged["fanout"],
        "shards": [merged["shards"][k] for k in sorted(merged["shards"])],
        "gangs_2pc": list(merged["gangs"].values()),
    }


def shards_main(argv: list[str]) -> int:
    """``kubectl-inspect-gpushare-cuda shards``: render the sharded
    extender's shard map — hash-ring ownership, per-shard WAL seq and
    journal queue depth, and cross-shard 2PC gangs in flight."""
    from .display import render_shards

    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda shards",
        description="Sharded-extender shard map",
    )
    p.add_argument("--shards-url", action="append", default=[],
                   metavar="URL",
                   help="a /shards endpoint (the shard router's "
                   "--metrics-port); repeatable — rows are merged by "
                   "shard id")
    p.add_argument("-o", "--output", default="table",
                   choices=["table", "json"])
    args = p.parse_args(argv)
    if not args.shards_url:
        print(
            "error: no --shards-url given — point me at the shard "
            "router's metrics port (e.g. --shards-url "
            "http://router:9114)",
            file=sys.stderr,
        )
        return 1
    doc = fetch_shards(args.shards_url)
    if args.output == "json":
        json.dump(doc, sys.stdout, indent=2)
        print()
        return 0
    sys.stdout.write(render_shards(doc))
    return 0


def fetch_fleet(urls: list[str]) -> dict:
    """Fetch + merge ``/fleet`` documents (a fleet may front several
    router replicas; replica rows merge by name, later endpoints
    winning ties). Unreachable endpoints warn but do not fail."""
    merged: dict = {
        "replicas": {}, "router": None, "scale": None,
        "prefix_hit_ratio": None,
    }
    for doc in _fetch_json_docs(urls, "/fleet"):
        for name, row in (doc.get("replicas") or {}).items():
            merged["replicas"][name] = row
        if merged["router"] is None:
            merged["router"] = doc.get("router")
            merged["scale"] = doc.get("scale")
            merged["prefix_hit_ratio"] = doc.get("prefix_hit_ratio")
    return {
        "replicas": {
            name: merged["replicas"][name]
            for name in sorted(merged["replicas"])
        },
        "router": merged["router"] or {},
        "scale": merged["scale"] or {},
        "prefix_hit_ratio": merged["prefix_hit_ratio"],
    }


def fleet_main(argv: list[str]) -> int:
    """``kubectl-inspect-gpushare-cuda fleet``: render the fleet router's
    replica map — per-replica health/state/queue depth, router routing
    outcomes and shed counts, scale-down drain status, and the global
    prefix-hit ratio."""
    from .display import render_fleet

    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda fleet",
        description="Fleet router replica map + routing outcomes",
    )
    p.add_argument("--fleet-url", action="append", default=[],
                   metavar="URL",
                   help="a /fleet endpoint (the fleet router's "
                   "--metrics-port); repeatable — replica rows are "
                   "merged by name")
    p.add_argument("-o", "--output", default="table",
                   choices=["table", "json"])
    args = p.parse_args(argv)
    if not args.fleet_url:
        print(
            "error: no --fleet-url given — point me at the fleet "
            "router's metrics port (e.g. --fleet-url "
            "http://router:9114)",
            file=sys.stderr,
        )
        return 1
    doc = fetch_fleet(args.fleet_url)
    if args.output == "json":
        json.dump(doc, sys.stdout, indent=2)
        print()
        return 0
    sys.stdout.write(render_fleet(doc))
    return 0


def trace_main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda trace",
        description="Render one pod's admission trace timeline",
    )
    p.add_argument("pod", help="[namespace/]name of an admitted share pod")
    p.add_argument("--traces-url", action="append", default=[],
                   help="a /traces endpoint to fetch spans from (the "
                   "extender's and/or node daemon's --metrics-port); "
                   "repeatable — spans from all endpoints are merged")
    p.add_argument("-o", "--output", default="tree", choices=["tree", "json"])
    args = p.parse_args(argv)
    ns, _, name = args.pod.rpartition("/")
    ns = ns or "default"
    try:
        pod = _client().get_pod(ns, name)
    except Exception as e:  # config errors / 404
        print(f"error: cannot read pod {ns}/{name}: {e}", file=sys.stderr)
        return 1
    raw = (pod.get("metadata", {}).get("annotations") or {}).get(
        const.ANN_TRACE_ID
    )
    if not raw:
        print(
            f"error: pod {ns}/{name} carries no {const.ANN_TRACE_ID} "
            "annotation (admitted before tracing, branch-B placement "
            "without the extender, or the trace was not sampled)",
            file=sys.stderr,
        )
        return 1
    trace_id = raw.split(":", 1)[0]
    if not args.traces_url:
        print(
            f"trace id: {trace_id}\n"
            "error: no --traces-url given — point me at the extender's "
            "and/or node daemon's metrics port (e.g. "
            "--traces-url http://node:9114)",
            file=sys.stderr,
        )
        return 1
    spans = fetch_trace_spans(args.traces_url, trace_id)
    if not spans:
        print(f"error: no spans found for trace {trace_id}", file=sys.stderr)
        return 1
    if args.output == "json":
        json.dump(spans, sys.stdout, indent=2)
        print()
        return 0
    sys.stdout.write(f"pod {ns}/{name}\n")
    sys.stdout.write(render_trace(spans))
    return 0


def top_main(argv: list[str]) -> int:
    """``kubectl-inspect-gpushare-cuda top``: periodically refreshed live view
    of per-chip co-residency, step p50/p99, interference verdicts, and
    SLO burn-rate / governor state."""
    import time as _time

    from .display import render_top

    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda top",
        description="Live per-chip co-residency / interference view",
    )
    p.add_argument("node", nargs="?", default="", help="restrict to one node")
    p.add_argument("--metrics-url", action="append", default=[],
                   metavar="URL",
                   help="a /metrics endpoint to scrape for step-profile, "
                   "SLO burn-rate, and governor telemetry (repeatable)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes")
    p.add_argument("--iterations", type=int, default=0,
                   help="number of refreshes then exit (0 = until ^C)")
    args = p.parse_args(argv)
    try:
        client = _client()
    except Exception as e:  # config errors
        print(f"error: cannot reach the cluster: {e}", file=sys.stderr)
        return 1
    i = 0
    try:
        while True:
            i += 1
            try:
                nodes, pods = gather(client, args.node)
            except SystemExit:
                raise
            except Exception as e:  # config errors / exhausted retries
                print(f"error: cannot reach the cluster: {e}", file=sys.stderr)
                return 1
            infos = build_all_node_infos(nodes, pods)
            obs = (
                fetch_observability_metrics(args.metrics_url)
                if args.metrics_url else None
            )
            out = render_top(
                infos, obs,
                now_label=_time.strftime("%H:%M:%S"),
            )
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")
            sys.stdout.write(out)
            sys.stdout.flush()
            if args.iterations and i >= args.iterations:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def flightrecord_main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda flightrecord",
        description="Summarize a flight-recorder dump file",
    )
    p.add_argument("path", help="a tpushare-flightrec-*.json dump")
    p.add_argument("-o", "--output", default="summary",
                   choices=["summary", "json"])
    p.add_argument("--max-traces", type=int, default=5)
    p.add_argument("--max-logs", type=int, default=20)
    args = p.parse_args(argv)
    from ..utils.flightrec import load_dump

    try:
        doc = load_dump(args.path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: cannot read flight record: {e}", file=sys.stderr)
        return 1
    if args.output == "json":
        json.dump(doc, sys.stdout, indent=2)
        print()
        return 0
    sys.stdout.write(
        render_flightrecord(
            doc, max_traces=args.max_traces, max_logs=args.max_logs
        )
    )
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Subcommand dispatch ahead of the legacy flat interface: the node
    # positional stays `inspect [node]`, observability verbs get words.
    if argv and argv[0] == "trace":
        return trace_main(argv[1:])
    if argv and argv[0] == "flightrecord":
        return flightrecord_main(argv[1:])
    if argv and argv[0] == "top":
        return top_main(argv[1:])
    if argv and argv[0] == "why":
        return why_main(argv[1:])
    if argv and argv[0] == "timeline":
        return timeline_main(argv[1:])
    if argv and argv[0] == "shards":
        return shards_main(argv[1:])
    if argv and argv[0] == "fleet":
        return fleet_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="kubectl-inspect-gpushare-cuda",
        description="Display the share of card memory in use across the cluster",
    )
    p.add_argument("node", nargs="?", default="", help="restrict to one node")
    p.add_argument("-d", "--details", action="store_true", help="per-pod rows")
    p.add_argument("-o", "--output", default="table", choices=["table", "json"],
                   help="output format (json: machine-readable, for "
                   "dashboards/automation)")
    p.add_argument("--metrics-url", action="append", default=[],
                   metavar="URL",
                   help="serving pod /metrics endpoint to scrape for KV-"
                   "page / prefix-cache / preemption telemetry (repeat "
                   "per pod; implies --details so the per-pod SERVING "
                   "CACHE column has rows to land on)")
    args = p.parse_args(argv)

    try:
        client = _client()
        nodes, pods = gather(client, args.node)
    except SystemExit:
        raise
    except Exception as e:  # config errors or exhausted list retries
        print(f"error: cannot reach the cluster: {e}", file=sys.stderr)
        return 1
    infos = build_all_node_infos(nodes, pods)
    obs = (
        fetch_observability_metrics(args.metrics_url)
        if args.metrics_url else None
    )
    engine = obs["engine"] if obs is not None else None
    build = (obs or {}).get("build") or None
    if args.output == "json":
        sys.stdout.write(render_json(infos, engine))
        return 0
    if not infos:
        print("no shared-TPU nodes found (allocatable aliyun.com/tpu-mem is 0 everywhere)")
        return 0
    out = (
        render_details(infos, engine, build=build)
        if args.details or engine is not None
        else render_summary(infos)
    )
    sys.stdout.write(out)
    return 0


def render_json(
    infos: list, engine: dict[str, dict[str, float]] | None = None
) -> str:
    """Machine-readable report: the same numbers the tables show,
    including the north-star cluster utilization line. ``engine``
    (``fetch_engine_metrics`` output) attaches each serving pod's cache
    telemetry as a ``serving_cache`` sub-document, plus a
    ``speculative`` sub-document for pods whose engine exports the
    ``tpushare_engine_spec_*`` families and an ``adapters`` sub-document
    for pods whose engine exports the multi-LoRA
    ``tpushare_engine_adapter_*`` families."""
    import json

    from .display import adapter_row_for, engine_row_for, spec_row_for
    from .nodeinfo import infer_unit

    total = sum(n.total_units for n in infos)
    used = sum(n.used_units for n in infos)

    def node_doc(n):
        held = set(n.core_held_chips)
        return {
            "name": n.name,
            "address": n.address,
            "total_units": n.total_units,
            "used_units": n.used_units,
            "pending_units": n.pending_units,
            # defrag-status annotation + per-chip stranded slivers, when
            # the node's daemon runs the defragmenter (the MOVES column's
            # machine-readable form)
            **(
                {
                    "defrag": {
                        **n.defrag,
                        "stranded_by_chip": {
                            str(i): u
                            for i, u in sorted(n.stranded_by_chip.items())
                        },
                    }
                }
                if n.defrag is not None
                else {}
            ),
            # interference verdicts (when the node's daemon runs the
            # detector): the parsed node annotation, per chip
            **(
                {"interference": n.interference}
                if n.interference is not None
                else {}
            ),
            "chips": [
                {
                    "index": d.index,
                    "total_units": d.total_units,
                    "used_units": d.used_units,
                    "core_held": d.index in held,
                    **(
                        {"stranded_units": n.stranded_by_chip.get(d.index, 0)}
                        if n.defrag is not None
                        else {}
                    ),
                }
                for d in sorted(n.devices.values(), key=lambda d: d.index)
            ],
            "pods": [
                {
                    "namespace": p.namespace,
                    "name": p.name,
                    "units_by_chip": {str(k): v for k, v in p.units_by_chip.items()},
                    "workload_class": p.workload_class,
                    # disaggregated-serving tier: emitted only when the
                    # pod declares one, preserving the no-disagg
                    # reference document
                    **(
                        {"serving_tier": p.serving_tier}
                        if p.serving_tier
                        else {}
                    ),
                    **(
                        {
                            "gang_shape": p.gang_shape,
                            "gang_per_chip": p.gang_per_chip,
                            "gang_coords": {
                                str(i): list(n.topology.coords(i))
                                for i in sorted(p.units_by_chip)
                                if n.topology is not None
                                and 0 <= i < n.topology.n_chips
                            },
                        }
                        if p.is_gang
                        else {}
                    ),
                    **(
                        {"serving_cache": engine_row_for(p, engine)}
                        if engine_row_for(p, engine)
                        else {}
                    ),
                    # speculative-decoding summary: emitted only when
                    # the pod's engine exports the spec families, so the
                    # no-speculation reference document is unchanged
                    **(
                        {
                            "speculative": spec_row_for(
                                engine_row_for(p, engine)
                            )
                        }
                        if spec_row_for(engine_row_for(p, engine))
                        else {}
                    ),
                    # multi-LoRA residency summary: same rule — only a
                    # pod whose engine exports the adapter families
                    # gains the key
                    **(
                        {
                            "adapters": adapter_row_for(
                                engine_row_for(p, engine)
                            )
                        }
                        if adapter_row_for(engine_row_for(p, engine))
                        else {}
                    ),
                }
                for p in n.pods
            ],
            "core_holds": [
                {
                    "namespace": h.namespace,
                    "name": h.name,
                    "chips": h.chips,
                    "requested": h.requested,
                }
                for h in n.core_holds
            ],
        }

    doc = {
        # same MiB/GiB heuristic the table headers use; without it a
        # consumer cannot compare unit counts across clusters
        "unit": infer_unit(infos),
        "nodes": [node_doc(n) for n in infos],
        "cluster": {
            "total_units": total,
            "used_units": used,
            "utilization_pct": round(100.0 * used / total, 1) if total else 0.0,
        },
    }
    return json.dumps(doc, indent=2) + "\n"


if __name__ == "__main__":
    sys.exit(main())
