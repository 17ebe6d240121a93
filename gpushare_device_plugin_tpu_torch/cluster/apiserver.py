"""Minimal kube-apiserver REST client, on the standard library alone.

Counterpart of ``gpushare_device_plugin_tpu/cluster/apiserver.py``. No
kubernetes client library is vendored: the plugin needs only a handful of
verbs (list pods/nodes with selectors, strategic-merge patch pod, patch
node status, the pod watch), all plain REST+JSON. Config resolution
mirrors upstream (``podmanager.go:29-57``): ``$KUBECONFIG`` if set, else
``~/.kube/config``, else the in-cluster serviceaccount (token + CA +
``KUBERNETES_SERVICE_HOST/PORT``).

Transport: every verb rides ``http.client``. The unary verbs keep one
persistent connection per thread (the Allocate hot path's PATCH is the
one unavoidable network round-trip, ``allocate.go:136-150``). The watch
opens a connection of its own and reads the chunked stream as it
arrives; its handle (:class:`WatchStream`) can be closed from another
thread to cancel a blocked read (the informer's stop path). The wire
(paths, selectors, PATCH bodies, the watch's JSON lines) is the
reference's byte for byte; the reference sends its watch through
``requests``, which the port does not need.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import ssl
import threading
import urllib.parse
from typing import Any, Callable, Iterator, Mapping

from ..utils.circuit import CircuitBreaker
from ..utils.faults import FAULTS
from ..utils.log import get_logger
from ..utils.lockrank import make_lock
from ..utils.metric_catalog import (
    PATCH_BATCH_RECORDS,
    PATCH_COALESCED_TOTAL as PATCH_COALESCED,
    PATCH_REQUESTS_TOTAL as PATCH_REQUESTS,
)

log = get_logger("cluster.apiserver")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
STRATEGIC_MERGE = "application/strategic-merge-patch+json"
MERGE_PATCH = "application/merge-patch+json"


class ApiError(RuntimeError):
    def __init__(self, status: int, body: str) -> None:
        super().__init__(f"apiserver HTTP {status}: {body[:300]}")
        self.status = status
        self.body = body


class WatchStream:
    """The handle of one live watch. :meth:`close` may be called from
    another thread: it shuts the socket down, which makes a read blocked
    in ``recv`` return at once (closing the file alone would wait out the
    read timeout, and closing a reader another thread is inside can
    block on its buffer lock). The reading thread releases the rest."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse) -> None:
        self._conn = conn
        self._resp = resp

    def close(self) -> None:
        sock = self._conn.sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:  # already closed or never connected
                pass

    def release(self) -> None:
        """Close the response and the connection (the reading thread's
        own teardown)."""
        self.close()
        for obj in (self._resp, self._conn):
            try:
                obj.close()
            except OSError:  # torn down already
                pass


class ApiServerClient:
    def __init__(
        self,
        base_url: str,
        token: str = "",
        ca_file: str | None = None,
        client_cert: tuple[str, str] | None = None,
        insecure: bool = False,
        timeout_s: float = 10.0,
        breaker: CircuitBreaker | None = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self._timeout = timeout_s
        # One breaker across every verb AND the watch: they share the
        # endpoint, so evidence of an outage from any of them should stop
        # all of them from stacking connect timeouts (see utils.circuit).
        self.breaker = breaker if breaker is not None else CircuitBreaker("apiserver")

        # Unary-verb transport: persistent http.client connections, one per
        # thread (HTTPConnection is not thread-safe; concurrent Allocate
        # workers share one client).
        u = urllib.parse.urlsplit(self.base_url)
        self._scheme = u.scheme or "http"
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if self._scheme == "https" else 80)
        # Path prefix in the server URL (proxied clusters, e.g.
        # https://gw.example/k8s/clusters/c-abc) must prefix every verb.
        self._base_path = u.path.rstrip("/")
        self._headers = {"Authorization": f"Bearer {token}"} if token else {}
        self._ssl_ctx: ssl.SSLContext | None = None
        if self._scheme == "https":
            if insecure:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            else:
                ctx = ssl.create_default_context(cafile=ca_file)
            if client_cert:
                ctx.load_cert_chain(client_cert[0], client_cert[1])
            self._ssl_ctx = ctx
        self._local = threading.local()
        # Lazily-built node-PATCH coalescer (patch_node_merged): one
        # dispatcher thread per client, created only if the merged verb is
        # actually used.
        self._coalescer_init_lock = make_lock("apiserver.coalescer")
        self._node_coalescer: "NodePatchCoalescer | None" = None

    def _new_connection(self) -> http.client.HTTPConnection:
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._host, self._port,
                context=self._ssl_ctx, timeout=self._timeout,
            )
        return http.client.HTTPConnection(
            self._host, self._port, timeout=self._timeout
        )

    def _connection(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._new_connection()
            self._local.conn = conn
        return conn

    def _request(
        self,
        method: str,
        path: str,
        params: Mapping[str, str] | None = None,
        body: str | None = None,
        content_type: str | None = None,
        timeout_s: float | None = None,
    ) -> tuple[int, str]:
        """One unary round-trip, gated by the circuit breaker.

        Transport failures and 5xx responses count against the breaker
        (both mean "the control plane is not serving us"); 2xx/4xx close
        it — a 404 or 409 is the apiserver working as intended.
        ``timeout_s`` overrides the client timeout for this call only
        (callers under an admission deadline can't afford the default).
        """
        self.breaker.before()  # raises CircuitOpenError while open
        try:
            status, text = self._do_request(
                method, path, params, body, content_type, timeout_s
            )
        except Exception:
            self.breaker.record_failure()
            raise
        if status >= 500:
            self.breaker.record_failure()
        else:
            self.breaker.record_success()
        return status, text

    def _do_request(
        self,
        method: str,
        path: str,
        params: Mapping[str, str] | None = None,
        body: str | None = None,
        content_type: str | None = None,
        timeout_s: float | None = None,
    ) -> tuple[int, str]:
        """One unary round-trip on the persistent connection.

        A keep-alive connection the server quietly closed surfaces as a
        failure on the *next* use (write succeeds into a dead socket, read
        gets EOF = ``RemoteDisconnected``) — retried once on a fresh
        connection. Non-idempotent verbs (PATCH/POST) retry ONLY on that
        zero-bytes-received signature or on send-phase failures: a timeout
        mid-response could mean the server already applied the change
        (re-sending a Binding would 409 a pod that is actually bound), so
        it propagates.
        """
        FAULTS.fire("apiserver.request")
        if params:
            path = path + "?" + urllib.parse.urlencode(params)
        path = self._base_path + path
        headers = dict(self._headers)
        if content_type:
            headers["Content-Type"] = content_type
        idempotent = method == "GET"
        for attempt in (0, 1):
            conn = self._connection()
            if timeout_s is not None:
                # Per-call override on the shared per-thread connection:
                # conn.timeout governs the (re)connect, settimeout the
                # reads on a live socket. Restored in the finally so later
                # callers on this thread get the client default back.
                conn.timeout = timeout_s
                if conn.sock is not None:
                    conn.sock.settimeout(timeout_s)
            sent = False
            try:
                conn.request(method, path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                return resp.status, resp.read().decode("utf-8", "replace")
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                self._local.conn = None
                try:
                    conn.close()
                except OSError:  # already dead; we're replacing it anyway
                    pass
                retriable = idempotent or not sent or isinstance(
                    e, http.client.RemoteDisconnected
                )
                if attempt or not retriable:
                    raise
            finally:
                if timeout_s is not None:
                    conn.timeout = self._timeout
                    try:
                        if conn.sock is not None:
                            conn.sock.settimeout(self._timeout)
                    except OSError:  # socket already dead
                        pass

    # --- construction ------------------------------------------------------

    @classmethod
    def from_env(cls, timeout_s: float = 10.0) -> "ApiServerClient":
        """$KUBECONFIG if set, else ~/.kube/config if present, else in-cluster.

        One resolution order for every binary (daemon, extender, CLIs) —
        the reference's CLIs had their own slightly different kubeInit
        (``cmd/inspect/podinfo.go:27-46``), a divergence not worth keeping.
        """
        kubeconfig = os.environ.get("KUBECONFIG", "")
        if kubeconfig and os.path.exists(kubeconfig):
            return cls.from_kubeconfig(kubeconfig, timeout_s=timeout_s)
        default = os.path.expanduser("~/.kube/config")
        if os.path.exists(default):
            return cls.from_kubeconfig(default, timeout_s=timeout_s)
        return cls.in_cluster(timeout_s=timeout_s)

    @classmethod
    def in_cluster(cls, timeout_s: float = 10.0) -> "ApiServerClient":
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not in cluster: KUBERNETES_SERVICE_HOST unset and no KUBECONFIG"
            )
        token = ""
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
        ca = os.path.join(SA_DIR, "ca.crt")
        return cls(
            f"https://{host}:{port}",
            token=token,
            ca_file=ca if os.path.exists(ca) else None,
            insecure=not os.path.exists(ca),
            timeout_s=timeout_s,
        )

    @classmethod
    def from_kubeconfig(cls, path: str, timeout_s: float = 10.0) -> "ApiServerClient":
        """A kubeconfig in JSON (which kubectl also reads) parses with the
        standard library; a YAML one needs PyYAML, imported only then."""
        import base64
        import tempfile

        with open(path) as f:
            text = f.read()
        try:
            cfg = json.loads(text) if text.strip() else {}
        except ValueError:
            try:
                import yaml
            except ImportError:
                raise RuntimeError(
                    f"kubeconfig {path} is not JSON, and reading YAML needs "
                    "PyYAML, which is not installed: write it as JSON "
                    "(kubectl config view --raw -o json)"
                ) from None
            cfg = yaml.safe_load(text)
        cfg = cfg or {}

        def materialize(data_b64: str, suffix: str) -> str:
            """Inline *-data credentials (kind/minikube/GKE kubeconfigs) ->
            temp file, since ssl wants paths."""
            f = tempfile.NamedTemporaryFile(
                mode="wb", suffix=suffix, delete=False, prefix="tpushare-kc-"
            )
            f.write(base64.b64decode(data_b64))
            f.close()
            return f.name

        ctx_name = cfg.get("current-context", "")
        ctx = {}
        for item in cfg.get("contexts", []) or []:
            if item.get("name") == ctx_name:
                ctx = item.get("context", {}) or {}
        cluster = {}
        for item in cfg.get("clusters", []) or []:
            if item.get("name") == ctx.get("cluster"):
                cluster = item.get("cluster", {}) or {}
        user = {}
        for item in cfg.get("users", []) or []:
            if item.get("name") == ctx.get("user"):
                user = item.get("user", {}) or {}

        server = cluster.get("server", "https://127.0.0.1:6443")
        insecure = bool(cluster.get("insecure-skip-tls-verify", False))
        ca_file = cluster.get("certificate-authority")
        if not ca_file and cluster.get("certificate-authority-data"):
            ca_file = materialize(cluster["certificate-authority-data"], ".crt")
        token = user.get("token", "")
        cert_file = user.get("client-certificate")
        key_file = user.get("client-key")
        if not cert_file and user.get("client-certificate-data"):
            cert_file = materialize(user["client-certificate-data"], ".crt")
        if not key_file and user.get("client-key-data"):
            key_file = materialize(user["client-key-data"], ".key")
        cert = (cert_file, key_file) if cert_file and key_file else None
        return cls(
            server,
            token=token,
            ca_file=ca_file,
            client_cert=cert,
            insecure=insecure,
            timeout_s=timeout_s,
        )

    # --- raw verbs ----------------------------------------------------------

    def _get(
        self,
        path: str,
        params: Mapping[str, str] | None = None,
        timeout_s: float | None = None,
    ) -> dict:
        status, text = self._request("GET", path, params, timeout_s=timeout_s)
        if status != 200:
            raise ApiError(status, text)
        return json.loads(text)

    def _patch(self, path: str, body: Any, content_type: str) -> dict:
        status, text = self._request("PATCH", path, body=json.dumps(body), content_type=content_type)
        if status not in (200, 201):
            raise ApiError(status, text)
        return json.loads(text)

    # --- typed helpers ------------------------------------------------------

    def list_pods(
        self,
        namespace: str | None = None,
        field_selector: str = "",
        label_selector: str = "",
    ) -> list[dict]:
        # Any falsy namespace ("" or None) means all namespaces — "" must
        # not build the malformed path /api/v1/namespaces//pods.
        if not namespace:
            return self.list_pods_with_rv(field_selector, label_selector)[0]
        params = {}
        if field_selector:
            params["fieldSelector"] = field_selector
        if label_selector:
            params["labelSelector"] = label_selector
        return self._get(
            f"/api/v1/namespaces/{namespace}/pods", params
        ).get("items", [])

    def list_pods_with_rv(
        self,
        field_selector: str = "",
        label_selector: str = "",
        timeout_s: float | None = None,
    ) -> tuple[list[dict], str]:
        """LIST returning (items, collection resourceVersion) — the seed for
        a subsequent watch. ``timeout_s`` bounds this one call (the
        informer's Allocate-path refresh runs under a deadline)."""
        params = {}
        if field_selector:
            params["fieldSelector"] = field_selector
        if label_selector:
            params["labelSelector"] = label_selector
        body = self._get("/api/v1/pods", params, timeout_s=timeout_s)
        return body.get("items", []), body.get("metadata", {}).get(
            "resourceVersion", "0"
        )

    def watch_pods(
        self,
        resource_version: str = "0",
        field_selector: str = "",
        label_selector: str = "",
        on_response: Callable[[Any], None] | None = None,
    ) -> Iterator[tuple[str, dict]]:
        """Streamed watch: yields (event_type, pod) one at a time until the
        server closes the connection. Compatibility wrapper over
        ``watch_pods_batched`` — consumers that can apply events in bulk
        (the informer) should use the batched form directly."""
        for batch in self.watch_pods_batched(
            resource_version=resource_version,
            field_selector=field_selector,
            label_selector=label_selector,
            on_response=on_response,
        ):
            yield from batch

    def watch_pods_batched(
        self,
        resource_version: str = "0",
        field_selector: str = "",
        label_selector: str = "",
        on_response: Callable[[Any], None] | None = None,
    ) -> Iterator[list[tuple[str, dict]]]:
        """Streamed watch yielding LISTS of (event_type, pod): every event
        decoded from one transport read is one batch. An idle watch yields
        singletons; a PATCH burst arrives as several lines in one read (the
        kernel buffers while the consumer processes the previous batch), so
        bursts coalesce naturally and the informer can apply each batch
        under a single cache-lock acquisition. Raises ApiError on non-200
        (e.g. 410 Gone -> relist).

        ``on_response`` (if given) receives the live :class:`WatchStream`
        so the caller can ``close()`` it from another thread to cancel the
        blocking read (the informer's stop path). A silent watch raises
        ``TimeoutError`` after ``max(timeout, 30)`` seconds.
        """
        params = {"watch": "true", "resourceVersion": resource_version}
        if field_selector:
            params["fieldSelector"] = field_selector
        if label_selector:
            params["labelSelector"] = label_selector
        path = self._base_path + "/api/v1/pods?" + urllib.parse.urlencode(params)
        # Stream *establishment* rides the breaker (it dials the same
        # endpoint as the unary verbs); mid-stream failures don't: a
        # server closing an hours-old watch is routine, not an outage.
        self.breaker.before()
        conn = self._new_connection()
        try:
            FAULTS.fire("apiserver.watch")
            conn.connect()  # bounded by the client timeout
            # the read timeout bounds a silent watch; the informer treats
            # it like a server hangup and re-watches
            conn.sock.settimeout(max(self._timeout, 30.0))
            conn.request("GET", path, headers=self._headers)
            resp = conn.getresponse()
        except Exception:
            conn.close()
            self.breaker.record_failure()
            raise
        if resp.status != 200:
            try:
                body = resp.read().decode("utf-8", "replace")
            finally:
                conn.close()
            if resp.status >= 500:
                self.breaker.record_failure()
            else:
                self.breaker.record_success()
            raise ApiError(resp.status, body)
        self.breaker.record_success()
        stream = WatchStream(conn, resp)
        if on_response is not None:
            on_response(stream)
        buf = b""
        try:
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break  # terminating chunk: the server closed the watch
                buf += chunk
                if b"\n" not in buf:
                    continue  # partial line: wait for the rest
                complete, _, buf = buf.rpartition(b"\n")
                batch = []
                for line in complete.split(b"\n"):
                    if not line.strip():
                        continue
                    evt = json.loads(line)
                    batch.append((evt.get("type", ""), evt.get("object", {})))
                if batch:
                    yield batch
        finally:
            stream.release()

    def get_pod(self, namespace: str, name: str) -> dict:
        return self._get(f"/api/v1/namespaces/{namespace}/pods/{name}")

    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        """Strategic-merge patch (reference: ``allocate.go:136-150``)."""
        return self._patch(
            f"/api/v1/namespaces/{namespace}/pods/{name}", patch, STRATEGIC_MERGE
        )

    def bind_pod(self, namespace: str, name: str, node: str) -> None:
        """POST pods/{name}/binding — used by the scheduler extender."""
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        status, text = self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
            body=json.dumps(body),
            content_type="application/json",
        )
        if status not in (200, 201):
            raise ApiError(status, text)

    def list_nodes(self, label_selector: str = "") -> list[dict]:
        params = {"labelSelector": label_selector} if label_selector else {}
        return self._get("/api/v1/nodes", params).get("items", [])

    def get_node(self, name: str) -> dict:
        return self._get(f"/api/v1/nodes/{name}")

    def patch_node(self, name: str, patch: dict) -> dict:
        """Strategic-merge patch on node metadata (fencing-generation
        annotation, allocator/checkpoint.py)."""
        return self._patch(f"/api/v1/nodes/{name}", patch, STRATEGIC_MERGE)

    def patch_node_status(self, name: str, capacity: Mapping[str, str]) -> dict:
        """Merge extended resources into node Status.Capacity/Allocatable.

        Reference: ``patchGPUCount`` via nodeutil.PatchNodeStatus
        (``podmanager.go:74-99``).
        """
        body = {
            "status": {
                "capacity": dict(capacity),
                "allocatable": dict(capacity),
            }
        }
        return self._patch(f"/api/v1/nodes/{name}/status", body, MERGE_PATCH)

    def create_event(self, namespace: str, event: dict) -> None:
        status, _ = self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/events",
            body=json.dumps(event),
            content_type="application/json",
        )
        if status not in (200, 201):
            log.warning("event create failed: HTTP %s", status)

    # --- coalesced writes ---------------------------------------------------

    def patch_node_merged(self, name: str, patch: dict) -> dict:
        """Coalesced ``patch_node``: concurrent metadata updates for the
        same node object merge into ONE strategic-merge PATCH (last writer
        wins per key, submit order preserved); every caller blocks until
        the merged PATCH has landed and gets the server's response."""
        with self._coalescer_init_lock:
            if self._node_coalescer is None:
                self._node_coalescer = NodePatchCoalescer(self)
        return self._node_coalescer.patch_node(name, patch)


# --- PATCH coalescing -------------------------------------------------------

PATCH_BATCH_RECORDS_HELP = (
    "PATCHes dispatched per coalescer flush (group-commit batch-size "
    "distribution for apiserver writes)"
)
PATCH_BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
PATCH_COALESCED_HELP = (
    "apiserver PATCH requests saved by coalescing: same-node metadata "
    "updates merged into one request (kind=node)"
)
PATCH_REQUESTS_HELP = (
    "Pod PATCH requests by transport: pipelined (batched on a shared "
    "keep-alive connection) vs sequential (single-item flush or fallback "
    "after a pipeline transport failure)"
)


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Strategic-merge-shaped dict merge: nested dicts merge recursively,
    scalars/lists overwrite (later submission wins — the same outcome two
    sequential PATCHes would have produced)."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class NodePatchCoalescer:
    """Group-commit for node-object metadata PATCHes: every update queued
    within one gather window collapses per node into a single merged
    strategic-merge PATCH. Callers keep synchronous semantics (block until
    the merged PATCH lands, receive the response, see the exception)."""

    def __init__(self, client: "ApiServerClient", window_s: float = 0.002) -> None:
        from ..utils.batch import GroupBatcher

        self._c = client
        self._batcher = GroupBatcher(
            self._flush, window_s=window_s, name="node-patch-coalescer"
        )

    def patch_node(self, name: str, patch: dict) -> dict:
        return self._batcher.submit((name, patch)).wait()

    def stop(self) -> None:
        self._batcher.stop()

    def _flush(self, items: list[tuple[str, dict]]) -> list:
        from ..utils.metrics import REGISTRY

        merged: dict[str, dict] = {}
        for name, patch in items:
            merged[name] = _deep_merge(merged.get(name, {}), patch)
        responses: dict[str, object] = {}
        for name, patch in merged.items():
            try:
                responses[name] = self._c.patch_node(name, patch)
            except Exception as e:  # noqa: BLE001 — per-item verdicts
                responses[name] = e
        saved = len(items) - len(merged)
        if saved:
            REGISTRY.counter_inc(
                PATCH_COALESCED, PATCH_COALESCED_HELP,
                value=float(saved), kind="node",
            )
        return [responses[name] for name, _patch in items]


class _SharedReaderSock:
    """Socket shim handing ``http.client.HTTPResponse`` a SHARED buffered
    reader: each response object must consume exactly its bytes from one
    stream (a fresh ``makefile()`` per response would strand pipelined
    bytes in an abandoned buffer)."""

    class _NoClose:
        def __init__(self, fp):
            self._fp = fp

        def close(self):  # HTTPResponse.close() must not kill the stream
            pass

        def flush(self):
            pass

        def __getattr__(self, name):
            return getattr(self._fp, name)

    def __init__(self, fp):
        self._fp = fp

    def makefile(self, *args, **kwargs):
        return self._NoClose(self._fp)


class PodPatchPipeline:
    """Coalesced pod-annotation PATCH dispatcher — the admission pipeline's
    write stage. Concurrently-committed admissions hand their (distinct-pod)
    PATCHes to one dispatcher; each gathered batch is sent **pipelined**
    over a small set of persistent connections (all requests written
    back-to-back, then all responses read in order), amortizing per-request
    client overhead and connection round-trips across the batch. Callers
    block on a per-batch ticket and get exactly the response (or ApiError)
    a direct ``patch_pod`` would have produced; WAL commits that depend on
    the PATCH therefore still strictly follow it.

    Fallback discipline: any transport trouble on the pipelined path drops
    the affected connection and re-issues the unanswered PATCHes one at a
    time through the ordinary client (which owns retry/breaker semantics) —
    strategic-merge annotation PATCHes are safe to re-send. Single-item
    batches skip the pipeline entirely.
    """

    def __init__(
        self,
        client: "ApiServerClient",
        window_s: float = 0.002,
        fanout: int = 4,
    ) -> None:
        from ..utils.batch import GroupBatcher
        from ..utils.metrics import REGISTRY

        self._c = client
        self._fanout = max(1, fanout)
        self._pipes: list[tuple | None] = [None] * self._fanout
        self._batcher = GroupBatcher(
            self._flush,
            window_s=window_s,
            name="pod-patch-pipeline",
            on_batch=lambda n: REGISTRY.observe(
                PATCH_BATCH_RECORDS, float(n), PATCH_BATCH_RECORDS_HELP,
                buckets=PATCH_BATCH_BUCKETS, kind="pod",
            ),
        )

    def patch_pod(self, namespace: str, name: str, patch: dict) -> dict:
        return self._batcher.submit((namespace, name, patch)).wait()

    def flush(self, timeout_s: float | None = 5.0) -> None:
        self._batcher.flush(timeout=timeout_s)

    def stop(self) -> None:
        self._batcher.stop()
        for i, pipe in enumerate(self._pipes):
            if pipe is not None:
                try:
                    pipe[0].close()
                except OSError:  # teardown race: already closed
                    pass
                self._pipes[i] = None

    # --- dispatcher internals --------------------------------------------

    def _flush(self, items: list[tuple[str, str, dict]]) -> list:
        from ..utils.metrics import REGISTRY

        self._c.breaker.before()  # open circuit fails the whole batch fast
        if len(items) == 1:
            return [self._sequential(*items[0])]
        results: list = [None] * len(items)
        # round-robin the batch over the pipe slots so the server works
        # the shards in parallel while each shard amortizes its RTTs
        shards: list[list[int]] = [[] for _ in range(min(self._fanout, len(items)))]
        for i in range(len(items)):
            shards[i % len(shards)].append(i)
        saw_5xx = False
        # Two phases: every shard's requests go out back-to-back BEFORE any
        # response is read, so the server processes all fanout connections
        # concurrently while this thread drains them in turn — reading
        # shard 0 to completion first would serialize the whole batch.
        sent = [
            self._send_shard(slot, [(i, items[i]) for i in indexes], results)
            for slot, indexes in enumerate(shards)
        ]
        for slot, indexes in enumerate(shards):
            answered = self._read_shard(
                slot, [(i, items[i]) for i in indexes], results, sent[slot]
            )
            for i in indexes[answered:]:
                if results[i] is None:  # faulted items already have verdicts
                    results[i] = self._sequential(*items[i])
        for r in results:
            if isinstance(r, ApiError) and r.status >= 500:
                saw_5xx = True
        if saw_5xx:
            self._c.breaker.record_failure()
        else:
            self._c.breaker.record_success()
        return results

    def _sequential(self, ns: str, name: str, patch: dict):
        from ..utils.metrics import REGISTRY

        REGISTRY.counter_inc(
            PATCH_REQUESTS, PATCH_REQUESTS_HELP, transport="sequential"
        )
        try:
            return self._c.patch_pod(ns, name, patch)
        except Exception as e:  # noqa: BLE001 — per-item verdicts
            return e

    def _pipe(self, slot: int):
        pipe = self._pipes[slot]
        if pipe is None:
            conn = self._c._new_connection()
            conn.connect()
            pipe = (conn, conn.sock.makefile("rb"))
            self._pipes[slot] = pipe
        return pipe

    def _drop_pipe(self, slot: int) -> None:
        pipe = self._pipes[slot]
        self._pipes[slot] = None
        if pipe is not None:
            try:
                pipe[1].close()
            except OSError:  # teardown race: already closed
                pass
            try:
                pipe[0].close()
            except OSError:  # teardown race: already closed
                pass

    def _send_shard(
        self, slot: int, shard: list[tuple[int, tuple[str, str, dict]]],
        results: list,
    ) -> list[int] | None:
        """Write every PATCH in ``shard`` back-to-back on the slot's
        connection. Returns the positions actually sent (fault-injected
        items get their verdicts recorded and are skipped), or None when
        the pipe was dead at send time (caller falls back sequentially).
        Fault-point and ApiError semantics match the unary client's."""
        c = self._c
        live: list[int] = []  # positions in `shard` actually sent
        requests_bytes: list[bytes] = []
        for pos, (i, (ns, name, patch)) in enumerate(shard):
            try:
                FAULTS.fire("apiserver.request")
            except Exception as e:  # noqa: BLE001 — injected per-item fault
                results[i] = e
                continue
            body = json.dumps(patch).encode()
            path = f"{c._base_path}/api/v1/namespaces/{ns}/pods/{name}"
            head = (
                f"PATCH {path} HTTP/1.1\r\n"
                f"Host: {c._host}:{c._port}\r\n"
                f"Content-Type: {STRATEGIC_MERGE}\r\n"
                f"Content-Length: {len(body)}\r\n"
            )
            for hk, hv in c._headers.items():
                head += f"{hk}: {hv}\r\n"
            requests_bytes.append(head.encode() + b"\r\n" + body)
            live.append(pos)
        if not live:
            return live
        try:
            conn, _fp = self._pipe(slot)
            conn.sock.sendall(b"".join(requests_bytes))
        except Exception:  # noqa: BLE001 — dead pipe: caller falls back
            self._drop_pipe(slot)
            return None
        return live

    def _read_shard(
        self, slot: int, shard: list[tuple[int, tuple[str, str, dict]]],
        results: list, live: list[int] | None,
    ) -> int:
        """Read the responses for a shard ``_send_shard`` wrote. Returns
        how many shard positions are fully resolved; the caller re-issues
        the rest sequentially."""
        if live is None:
            return 0  # send failed outright: everything falls back
        if not live:
            return len(shard)  # nothing was sent (all faulted, verdicts set)
        from ..utils.metrics import REGISTRY

        pipe = self._pipes[slot]
        if pipe is None:
            return live[0]
        fp = pipe[1]
        close_after = False
        for pos in live:
            i = shard[pos][0]
            try:
                resp = http.client.HTTPResponse(
                    _SharedReaderSock(fp), method="PATCH"
                )
                resp.begin()
                data = resp.read()
                close_after = close_after or resp.will_close
            except Exception:  # noqa: BLE001 — torn stream mid-pipeline
                self._drop_pipe(slot)
                return pos  # this item and the rest go sequential
            REGISTRY.counter_inc(
                PATCH_REQUESTS, PATCH_REQUESTS_HELP, transport="pipelined"
            )
            if resp.status in (200, 201):
                try:
                    results[i] = json.loads(data)
                except ValueError as e:
                    results[i] = ApiError(
                        resp.status,
                        data.decode("utf-8", "replace")[:300]
                        + f" (bad json: {e})",
                    )
            else:
                results[i] = ApiError(resp.status, data.decode("utf-8", "replace"))
        if close_after:
            self._drop_pipe(slot)
        return len(shard)
