"""Direct kubelet REST client: ``GET https://<node>:10250/pods/``.

Counterpart of ``gpushare_device_plugin_tpu/cluster/kubelet.py``, on
``http.client`` where the reference uses ``requests``. Upstream:
``pkg/kubelet/client/client.go:39-134``, a bearer-token HTTPS GET with TLS
verification deliberately skipped (the kubelet serving cert is rarely
signed for the node IP; upstream strips the CA for the same reason,
``client.go:79-83``). Returns the kubelet's authoritative local pod list,
which the Allocate path prefers for freshness when ``--query-kubelet`` is
set.
"""

from __future__ import annotations

import http.client
import json
import ssl

from ..utils.faults import FAULTS
from ..utils.log import get_logger

log = get_logger("cluster.kubelet")


class KubeletError(RuntimeError):
    """A non-2xx answer from the kubelet's ``/pods/``."""

    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"kubelet HTTP {status}: {body[:300]}")
        self.status = status


class KubeletClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 10250,
        token: str = "",
        client_cert: tuple[str, str] | None = None,
        timeout_s: float = 10.0,
        scheme: str = "https",
    ) -> None:
        self.base_url = f"{scheme}://{host}:{port}"
        self._host = host
        self._port = port
        self._scheme = scheme
        self._timeout = timeout_s
        self._headers = {"Authorization": f"Bearer {token}"} if token else {}
        self._ssl_ctx: ssl.SSLContext | None = None
        if scheme == "https":
            # kubelet serving certs: see module doc
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            if client_cert:
                ctx.load_cert_chain(client_cert[0], client_cert[1])
            self._ssl_ctx = ctx

    def get_node_running_pods(self) -> list[dict]:
        """The kubelet's local ``v1.PodList`` (``client.go:119-134``)."""
        FAULTS.fire("kubelet.pods")
        if self._scheme == "https":
            conn = http.client.HTTPSConnection(
                self._host, self._port, context=self._ssl_ctx,
                timeout=self._timeout,
            )
        else:
            conn = http.client.HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
        try:
            conn.request("GET", "/pods/", headers=self._headers)
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        if resp.status >= 400:
            raise KubeletError(resp.status, body.decode("utf-8", "replace"))
        return json.loads(body).get("items", [])
