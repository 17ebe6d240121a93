"""Debug CLI: dump the kubelet's local pod list.

Counterpart of ``gpushare_device_plugin_tpu/cli/podgetter.py`` (upstream:
``cmd/podgetter/main.go``): the same client flag set as the daemon's
kubelet path; prints the raw ``/pods`` result for debugging the
``--query-kubelet`` source::

    gpushare-podgetter-cuda --kubelet-address 127.0.0.1 --token $TOKEN
"""

from __future__ import annotations

import argparse
import json
import sys

from ..cluster.kubelet import KubeletClient
from .daemon import build_kubelet_token


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpushare-podgetter-cuda")
    p.add_argument("--kubelet-address", default="127.0.0.1")
    p.add_argument("--kubelet-port", type=int, default=10250)
    p.add_argument("--client-cert", default="")
    p.add_argument("--client-key", default="")
    p.add_argument("--token", default="")
    p.add_argument("--timeout", type=float, default=10.0)
    p.add_argument("--scheme", default="https", choices=["https", "http"])
    args = p.parse_args(argv)

    cert = None
    if args.client_cert and args.client_key:
        cert = (args.client_cert, args.client_key)
    client = KubeletClient(
        host=args.kubelet_address,
        port=args.kubelet_port,
        token=build_kubelet_token(args),
        client_cert=cert,
        timeout_s=args.timeout,
        scheme=args.scheme,
    )
    try:
        pods = client.get_node_running_pods()
    except Exception as e:
        print(f"error: kubelet query failed: {e}", file=sys.stderr)
        return 1
    json.dump({"items": pods}, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
