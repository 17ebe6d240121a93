"""Daemon entry point: ``gpushare-device-plugin-cuda``, the node agent a
DaemonSet runs on every GPU node.

Counterpart of ``gpushare_device_plugin_tpu/cli/daemon.py``, cut to
standalone mode (upstream: ``cmd/nvidia/main.go:15-78``: flag parsing,
memory-unit validation, then hand-off to the lifecycle manager)::

    python -m gpushare_device_plugin_tpu_torch.cli.daemon --standalone \\
        [--discovery auto|nvml|cuda|mock] [--health-check] [--metrics-port N]

The daemon finds the cards (NVML by default, through ``auto``), serves
``aliyun.com/tpu-mem`` and ``aliyun.com/tpu-core`` to kubelet, accounts
grants in-process, and re-registers when kubelet restarts. Signals:
SIGHUP rebuilds and re-registers, SIGQUIT writes an all-thread stack dump
into ``--coredump-dir``, SIGUSR1 a flight record into
``--flightrecord-dir``, and SIGTERM/SIGINT drain in-flight Allocate calls
(new ones are refused) before the plugin sockets close and the process
exits 0. Without ``--standalone`` it exits nonzero: cluster mode (the
apiserver-backed allocators and their journal) is not ported yet.

The process imports neither torch nor JAX and, with NVML discovery,
opens no CUDA context.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import const
from ..discovery import from_name
from ..manager import ManagerConfig, TpuShareManager
from ..utils import log as logutil

log = logutil.get_logger("daemon")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gpushare-device-plugin-cuda",
        description="GPU-sharing Kubernetes device plugin (fractional device "
        "memory + whole cards), standalone mode",
    )
    p.add_argument("--standalone", action="store_true",
                   help="no apiserver: in-process accounting (required: "
                   "cluster mode is not ported yet)")
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
                   help="this node's name (logged; cluster mode reads it)")
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
    p.add_argument("--drain-timeout", type=float, default=5.0,
                   help="graceful-shutdown budget for in-flight Allocate "
                   "calls before the gRPC sockets close")
    p.add_argument("--decisions-ring", type=int, default=512,
                   help="in-memory decision-provenance ring size, served "
                   "on /decisions; 0 disables emission")
    p.add_argument("--decisions-log", default="",
                   help="optional on-disk decision segment log (JSON "
                   "lines, size-rotated); empty disables")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logutil.setup(args.verbosity)
    if not args.standalone:
        log.fatal("cluster mode is not ported yet: run with --standalone")

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
    cfg = ManagerConfig(
        plugin_dir=args.plugin_dir,
        memory_unit=const.translate_memory_units(args.memory_unit),
        policy=args.policy,
        health_check=args.health_check,
        standalone=True,
        serve_core_resource=not args.no_core_resource,
        disable_isolation=args.disable_isolation,
        coredump_dir=args.coredump_dir,
        drain_timeout_s=args.drain_timeout,
        flightrecord_dir=flightrecord_dir,
        flightrecord_keep=args.flightrecord_keep,
        decisions_ring=args.decisions_ring,
        decisions_log_path=args.decisions_log,
    )
    manager = TpuShareManager(backend, cfg)
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
            "policy=%s standalone",
            args.node_name, args.discovery, type(backend).__name__, args.policy,
        )
        manager.run()
    finally:
        if metrics_server is not None:
            metrics_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
