"""Daemon entry point: ``gpushare-device-plugin-cuda``, the node agent a
DaemonSet runs on every GPU node.

Counterpart of ``gpushare_device_plugin_tpu/cli/daemon.py`` (upstream:
``cmd/nvidia/main.go:15-78``: flag parsing, kubelet-client construction
with the serviceaccount-token fallback, memory-unit validation, then
hand-off to the lifecycle manager)::

    python -m gpushare_device_plugin_tpu_torch.cli.daemon --node-name N \\
        [--discovery auto|nvml|cuda|mock] [--health-check] [--metrics-port N]

The daemon finds the cards (NVML by default, through ``auto``), serves
``aliyun.com/tpu-mem`` and ``aliyun.com/tpu-core`` to kubelet and
re-registers when kubelet restarts. In cluster mode (the default) it reads
a kubeconfig (``$KUBECONFIG``, then ``~/.kube/config``; JSON needs nothing
beyond the standard library) or the in-cluster service account, watches
its node's pods through an informer (``--pod-source list`` LISTs per
Allocate, ``--query-kubelet`` asks the kubelet), admits each pod the
scheduler extender assumed, journals each admission to the WAL
(``--checkpoint-path``, default ``<plugin-dir>/tpushare-allocations.ckpt``)
before writing the pod's annotations, and on restart claims the fence and
replays unresolved entries for the drift reconciler
(``--reconcile-interval``) to resolve. A deleted pod's units come back
with it. ``--standalone`` runs without an apiserver and accounts grants
in-process, never reclaimed. Cluster mode also runs the node's loops: live
defragmentation (``--defrag-interval``, off by default), the interference
detector (``--interference-interval``, off by default, scraping each
``--interference-scrape-url``) and the timeline sampler
(``--timeline-interval``, every 10 s by default).

Signals: SIGHUP rebuilds and re-registers, SIGQUIT writes an all-thread
stack dump into ``--coredump-dir``, SIGUSR1 a flight record into
``--flightrecord-dir``, and SIGTERM/SIGINT drain in-flight Allocate calls
(new ones are refused; each finishes its PATCH and journal commit) before
the plugin sockets close, the journal is flushed and the process exits 0.
A hard kill at any instruction is survivable through the WAL and replay.

The process imports neither torch nor JAX and, with NVML discovery,
opens no CUDA context.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import const
from ..cluster.apiserver import ApiServerClient
from ..cluster.informer import PodInformer
from ..cluster.kubelet import KubeletClient
from ..cluster.podsource import ApiServerPodSource, KubeletPodSource
from ..discovery import from_name
from ..manager import ManagerConfig, TpuShareManager
from ..utils import log as logutil

SA_TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"

log = logutil.get_logger("daemon")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpushare-device-plugin-cuda",
        description="GPU-sharing Kubernetes device plugin (fractional device "
        "memory + whole cards)",
    )
    # upstream flag set (cmd/nvidia/main.go:15-26)
    p.add_argument("--query-kubelet", action="store_true",
                   help="source pods from kubelet /pods instead of the apiserver")
    p.add_argument("--pod-source", default="informer",
                   choices=["informer", "list"],
                   help="apiserver read strategy: watch-backed cache "
                   "(informer, default) or a fresh LIST per Allocate; "
                   "ignored with --query-kubelet")
    p.add_argument("--kubelet-address", default="127.0.0.1")
    p.add_argument("--kubelet-port", type=int, default=10250)
    p.add_argument("--client-cert", default="")
    p.add_argument("--client-key", default="")
    p.add_argument("--token", default="", help="kubelet bearer token "
                   "(default: serviceaccount token file)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="kubelet/apiserver HTTP timeout seconds")
    p.add_argument("--standalone", action="store_true",
                   help="no apiserver: in-process accounting, never "
                   "reclaimed (dev/bench)")
    p.add_argument("--discovery", default="auto",
                   choices=["auto", "nvml", "cuda", "mock"],
                   help="card discovery backend; auto tries NVML, then "
                   "CUDA, else finds no card and parks")
    p.add_argument("--health-check", action="store_true",
                   help="enable card health monitoring into ListAndWatch "
                   "and the allocator")
    p.add_argument("--memory-unit", default="GiB", choices=["GiB", "MiB"],
                   help="granularity of one tpu-mem unit")
    p.add_argument("--policy", default="first-fit",
                   choices=["first-fit", "best-fit", "spread"])
    p.add_argument("--no-core-resource", action="store_true",
                   help="do not serve the whole-card tpu-core resource")
    p.add_argument("--disable-isolation", action="store_true",
                   help="never inject the cooperative memory cap")
    p.add_argument("--plugin-dir", default=const.DEVICE_PLUGIN_PATH)
    p.add_argument("--node-name", default=os.environ.get("NODE_NAME", ""),
                   help="this node's name (required in cluster mode)")
    p.add_argument("--coredump-dir", default="/etc/kubernetes",
                   help="where SIGQUIT writes its all-thread stack dump")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics, /traces, /decisions, /timeline, "
                   "/healthz and /readyz on this port (0 = off)")
    p.add_argument("--trace-sample", type=float, default=1.0,
                   help="admission-trace sample ratio in [0,1]; 0 disables")
    p.add_argument("--trace-sample-critical", type=float, default=None,
                   help="per-tier override of --trace-sample for "
                   "critical-tier serving traces")
    p.add_argument("--trace-sample-besteffort", type=float, default=None,
                   help="per-tier override of --trace-sample for "
                   "best-effort serving traces")
    p.add_argument("--flightrecord-dir", default="",
                   help="flight-recorder directory (last N traces + recent "
                   "log ring, dumped on SIGUSR1, fatal exit and injected "
                   "crash sites); default is the coredump dir, 'none' "
                   "disables")
    p.add_argument("--flightrecord-keep", type=int, default=16,
                   help="keep only the newest K flight-record dump files "
                   "(0 = unbounded)")
    p.add_argument("--interference-interval", type=float, default=0.0,
                   help="seconds between interference-detector passes "
                   "(per-card co-residency against decode-step p99 "
                   "inflation, published as the tpushare_interference_ratio "
                   "gauge and the node interference annotation); 0 disables")
    p.add_argument("--interference-threshold", type=float, default=1.25,
                   help="step-p99 inflation ratio (current / solo baseline) "
                   "at which a co-residency verdict is flagged")
    p.add_argument("--interference-scrape-url", action="append", default=[],
                   metavar="URL",
                   help="a serving pod's /metrics endpoint to scrape for its "
                   "engine's step-p99 gauge (repeatable); without any, the "
                   "detector reads this process's own registry")
    # degraded-mode knobs
    p.add_argument("--breaker-threshold", type=int, default=5,
                   help="consecutive apiserver failures before the circuit "
                   "opens and calls fail fast")
    p.add_argument("--breaker-reset-s", type=float, default=5.0,
                   help="seconds the circuit stays open before a half-open "
                   "probe")
    # crash-safe state (allocator/checkpoint.py)
    p.add_argument("--checkpoint-path", default="",
                   help="write-ahead allocation journal file; default is "
                   "<plugin-dir>/tpushare-allocations.ckpt in cluster mode "
                   "(the device-plugin dir is a host path, so the journal "
                   "survives container restarts); 'none' disables")
    p.add_argument("--wal-fsync", default="batch", choices=["always", "batch"],
                   help="WAL durability mode: 'batch' (group commit: one "
                   "fsync covers every record queued within the gather "
                   "window; no admission proceeds past begin until its "
                   "record is durable) or 'always' (fsync per record)")
    p.add_argument("--wal-batch-window-ms", type=float, default=2.0,
                   help="group-commit gather window in milliseconds "
                   "(--wal-fsync=batch)")
    p.add_argument("--no-patch-coalesce", action="store_true",
                   help="send one apiserver PATCH per admission from the "
                   "calling thread instead of the coalesced dispatcher")
    p.add_argument("--reconcile-interval", type=float, default=30.0,
                   help="seconds between drift-reconciler passes "
                   "(annotations vs ledger vs checkpoint); 0 disables")
    p.add_argument("--drain-timeout", type=float, default=5.0,
                   help="graceful-shutdown budget for in-flight Allocate "
                   "calls before the gRPC sockets close")
    p.add_argument("--defrag-interval", type=float, default=0.0,
                   help="seconds between live slice-defragmentation passes "
                   "(journaled move protocol); 0 disables (the default: "
                   "repacking moves running workloads)")
    p.add_argument("--defrag-quantum", type=int, default=0,
                   help="stranded-sliver threshold in memory units: free "
                   "memory on a partially-used card below this counts as "
                   "stranded; 0 derives it from the largest fractional pod "
                   "on the node")
    p.add_argument("--defrag-max-moves", type=int, default=8,
                   help="upper bound on repacking moves planned per pass")
    p.add_argument("--timeline-interval", type=float, default=10.0,
                   help="seconds between cluster-state timeline samples "
                   "(utilization, stranded %%, pending depth, SLO burn into "
                   "the /timeline ring and flight records); 0 disables")
    p.add_argument("--decisions-ring", type=int, default=512,
                   help="in-memory decision-provenance ring size, served "
                   "on /decisions; 0 disables emission")
    p.add_argument("--decisions-log", default="",
                   help="optional on-disk decision segment log (JSON "
                   "lines, size-rotated); empty disables")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    return p


def build_kubelet_token(args) -> str:
    """Explicit flag, else the in-cluster serviceaccount token
    (upstream ``cmd/nvidia/main.go:28-53``)."""
    if args.token:
        return args.token
    if os.path.exists(SA_TOKEN_PATH):
        with open(SA_TOKEN_PATH) as f:
            return f.read().strip()
    return ""


def build_pod_source(args, api_client: ApiServerClient):
    """The Allocate path's pod reads: the kubelet with the apiserver as
    its fallback, a LIST per read, or (the default) the informer."""
    apisrc = ApiServerPodSource(api_client, args.node_name)
    if args.query_kubelet:
        cert = None
        if args.client_cert and args.client_key:
            cert = (args.client_cert, args.client_key)
        kubelet = KubeletClient(
            host=args.kubelet_address,
            port=args.kubelet_port,
            token=build_kubelet_token(args),
            client_cert=cert,
            timeout_s=args.timeout,
        )
        return KubeletPodSource(kubelet, apisrc, args.node_name)
    if args.pod_source == "informer":
        return PodInformer(api_client, args.node_name).start()
    return apisrc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logutil.setup(args.verbosity)

    # fault injection (TPUSHARE_FAULTS="plugin.allocate=latency:2,...")
    from ..utils.faults import FAULTS

    if FAULTS.install_from_env():
        log.warning("fault injection ACTIVE at points: %s", FAULTS.active())

    from ..utils.tracing import TRACER

    tier_ratios = {}
    if args.trace_sample_critical is not None:
        tier_ratios[const.SLO_TIER_CRITICAL] = args.trace_sample_critical
    if args.trace_sample_besteffort is not None:
        tier_ratios[const.SLO_TIER_BEST_EFFORT] = args.trace_sample_besteffort
    TRACER.configure(sample_ratio=args.trace_sample, tier_ratios=tier_ratios or None)
    flightrecord_dir = args.flightrecord_dir
    if flightrecord_dir == "none":
        flightrecord_dir = ""
    elif not flightrecord_dir:
        flightrecord_dir = args.coredump_dir

    backend = from_name(args.discovery)
    # WAL default: on in cluster mode, under the plugin dir (a hostPath in
    # every real deployment, so the journal outlives the container).
    checkpoint_path = args.checkpoint_path
    if checkpoint_path == "none":
        checkpoint_path = ""
    elif not checkpoint_path and not args.standalone:
        checkpoint_path = os.path.join(args.plugin_dir, "tpushare-allocations.ckpt")
    cfg = ManagerConfig(
        plugin_dir=args.plugin_dir,
        node_name=args.node_name,
        memory_unit=const.translate_memory_units(args.memory_unit),
        policy=args.policy,
        health_check=args.health_check,
        standalone=args.standalone,
        serve_core_resource=not args.no_core_resource,
        disable_isolation=args.disable_isolation,
        coredump_dir=args.coredump_dir,
        checkpoint_path=checkpoint_path,
        wal_fsync=args.wal_fsync,
        wal_batch_window_s=args.wal_batch_window_ms / 1000.0,
        patch_coalesce=not args.no_patch_coalesce,
        reconcile_interval_s=args.reconcile_interval,
        drain_timeout_s=args.drain_timeout,
        flightrecord_dir=flightrecord_dir,
        flightrecord_keep=args.flightrecord_keep,
        defrag_interval_s=args.defrag_interval,
        defrag_quantum=args.defrag_quantum,
        defrag_max_moves=args.defrag_max_moves,
        interference_interval_s=args.interference_interval,
        interference_threshold=args.interference_threshold,
        interference_scrape_urls=tuple(args.interference_scrape_url),
        timeline_interval_s=args.timeline_interval,
        decisions_ring=args.decisions_ring,
        decisions_log_path=args.decisions_log,
    )
    api_client = None
    pod_source = None
    if not args.standalone:
        if not args.node_name:
            log.fatal("NODE_NAME env (or --node-name) is required in cluster mode")
        try:
            api_client = ApiServerClient.from_env(timeout_s=args.timeout)
        except Exception as e:  # bad/garbled kubeconfig, missing SA, etc.
            log.fatal(f"apiserver config failed: {e} (use --standalone for no-cluster mode)")
        from ..utils.circuit import CircuitBreaker

        api_client.breaker = CircuitBreaker(
            "apiserver",
            failure_threshold=args.breaker_threshold,
            reset_timeout_s=args.breaker_reset_s,
        )
        pod_source = build_pod_source(args, api_client)

    manager = TpuShareManager(backend, cfg, api_client=api_client, pod_source=pod_source)
    metrics_server = None
    if args.metrics_port:
        from ..utils.metrics import MetricsServer, publish_build_info

        publish_build_info(component="daemon")
        # /readyz gates on kubelet plugin registration: the DaemonSet's
        # readiness probe (a daemon whose plugins never registered serves
        # no pods, whatever its process state).
        metrics_server = MetricsServer(port=args.metrics_port, ready_fn=manager.ready).start()
        log.info("metrics on :%d/metrics", metrics_server.port)

    try:
        manager.install_signal_handlers()
        log.info(
            "gpushare-device-plugin-cuda starting on node %r: discovery=%s (%s) "
            "policy=%s standalone=%s",
            args.node_name, args.discovery, type(backend).__name__, args.policy,
            args.standalone,
        )
        manager.run()
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        # The informer owns a watch thread and an open HTTP stream: shut
        # it down with the manager instead of abandoning it to teardown.
        stop = getattr(pod_source, "stop", None)
        if callable(stop):
            stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
