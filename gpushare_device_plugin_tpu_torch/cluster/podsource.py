"""Pod sourcing for the Allocate path, with the reference's retry budgets.

Counterpart of ``gpushare_device_plugin_tpu/cluster/podsource.py``,
copied whole.

Two backends (reference: ``podmanager.go:127-245``):
- kubelet ``/pods`` with 8 x 100 ms retries, falling back to the apiserver
  (``podmanager.go:141-157``) — fresher, preferred with ``--query-kubelet``;
- apiserver LIST with field selector
  ``spec.nodeName=<node>,status.phase=Pending`` and 3 x 1 s retries
  (``podmanager.go:159-176``).
"""

from __future__ import annotations

from typing import Protocol

from ..utils.log import get_logger
from ..utils.retry import RetryError, retry
from . import pods as P
from .apiserver import ApiServerClient
from .kubelet import KubeletClient

log = get_logger("cluster.podsource")

# Attempt counts keep the reference's budgets (``podmanager.go:143-147,
# 164-176``); the fixed delays became exponential backoff with full jitter
# plus a per-call deadline — these reads sit on the Allocate admission
# path, so a dead control plane must produce an error while kubelet still
# cares, and a recovering one must not be hit by synchronized retries.
KUBELET_RETRIES = 8
KUBELET_DELAY_S = 0.05
KUBELET_DEADLINE_S = 2.0
APISERVER_RETRIES = 3
APISERVER_DELAY_S = 0.25
APISERVER_DEADLINE_S = 5.0
_BACKOFF = dict(backoff=2.0, jitter=True)


def _apiserver_retry(fn):
    return retry(
        fn,
        attempts=APISERVER_RETRIES,
        delay_s=APISERVER_DELAY_S,
        deadline_s=APISERVER_DEADLINE_S,
        **_BACKOFF,
    )


class PodSource(Protocol):
    def pending_pods(self) -> list[dict]:
        """Pods on this node that may be awaiting allocation."""
        ...

    def pending_share_pods(self, resource: str) -> list[dict]:
        """Pending pods requesting ``resource`` — the allocator's match
        universe. List-backed sources filter a fresh pending LIST; the
        informer serves its pending-by-resource index (O(bucket))."""
        ...

    def running_share_pods(self) -> list[dict]:
        """Running pods bearing the tpushare label (usage accounting)."""
        ...

    def labeled_pods(self) -> list[dict]:
        """All pods bearing the tpu/resource label (either value) — one
        snapshot for cross-resource accounting per Allocate."""
        ...

    def refresh(self) -> None:
        """Make the next reads at least as fresh as the apiserver now.

        No-op for list-backed sources (every read is a fresh LIST); the
        informer uses it to close its watch-lag window on a match miss.
        """
        ...

    def note_pod_update(self, pod: dict) -> None:
        """Inform the source of a pod the caller just wrote (PATCH result)."""
        ...

    def evict(self, pod: dict) -> None:
        """Inform the source a pod is gone on the server (e.g. PATCH 404).

        No-op for list-backed sources; the informer drops it from its cache
        so a deleted pod can't shadow a live same-size candidate.
        """
        ...

    def chip_state(self) -> tuple[dict[int, int], set[int]]:
        """One consistent usage read for the Allocate path: -> (mem units
        used per chip, exclusively-held chips). List-backed sources derive
        it from a labeled-pods snapshot; the informer maintains it
        incrementally (O(chips) per admission)."""
        ...


def _chip_state_from(labeled_pods: list[dict]) -> tuple[dict[int, int], set[int]]:
    return P.used_units_by_chip(labeled_pods), P.used_chips(labeled_pods)


class ApiServerPodSource:
    def __init__(self, client: ApiServerClient, node_name: str) -> None:
        self._c = client
        self._node = node_name

    def refresh(self) -> None:
        pass  # every read LISTs — always fresh

    def note_pod_update(self, pod: dict) -> None:
        pass  # ditto

    def evict(self, pod: dict) -> None:
        pass  # nothing cached

    def pending_pods(self) -> list[dict]:
        return _apiserver_retry(
            lambda: self._c.list_pods(
                field_selector=f"spec.nodeName={self._node},status.phase=Pending"
            )
        )

    def pending_share_pods(self, resource: str) -> list[dict]:
        return [
            p
            for p in self.pending_pods()
            if P.mem_units_of_pod(p, resource=resource) > 0
        ]

    def running_share_pods(self) -> list[dict]:
        from .. import const

        return _apiserver_retry(
            lambda: self._c.list_pods(
                field_selector=f"spec.nodeName={self._node}",
                label_selector=f"{const.LABEL_RESOURCE_KEY}={const.LABEL_RESOURCE_VALUE}",
            )
        )

    def labeled_pods(self) -> list[dict]:
        from .. import const

        # existence selector: one LIST covers both resource values
        return _apiserver_retry(
            lambda: self._c.list_pods(
                field_selector=f"spec.nodeName={self._node}",
                label_selector=const.LABEL_RESOURCE_KEY,
            )
        )

    def chip_state(self) -> tuple[dict[int, int], set[int]]:
        return _chip_state_from(self.labeled_pods())


class KubeletPodSource:
    """Kubelet-first with apiserver fallback (``podmanager.go:141-157``)."""

    def __init__(
        self,
        kubelet: KubeletClient,
        fallback: ApiServerPodSource,
        node_name: str,
    ) -> None:
        self._kubelet = kubelet
        self._fallback = fallback
        self._node = node_name

    def refresh(self) -> None:
        pass  # every read hits kubelet/apiserver — always fresh

    def note_pod_update(self, pod: dict) -> None:
        pass  # ditto

    def evict(self, pod: dict) -> None:
        pass  # nothing cached

    def _kubelet_pods(self) -> list[dict]:
        return retry(
            self._kubelet.get_node_running_pods,
            attempts=KUBELET_RETRIES,
            delay_s=KUBELET_DELAY_S,
            deadline_s=KUBELET_DEADLINE_S,
            **_BACKOFF,
        )

    def pending_pods(self) -> list[dict]:
        try:
            pods = self._kubelet_pods()
        except RetryError as e:
            log.warning("kubelet /pods failed (%s); falling back to apiserver", e)
            return self._fallback.pending_pods()
        # kubelet reports all local pods; keep the pending ones
        return [p for p in pods if P.phase(p) == "Pending"]

    def pending_share_pods(self, resource: str) -> list[dict]:
        return [
            p
            for p in self.pending_pods()
            if P.mem_units_of_pod(p, resource=resource) > 0
        ]

    def running_share_pods(self) -> list[dict]:
        from .. import const

        try:
            pods = self._kubelet_pods()
        except RetryError:
            return self._fallback.running_share_pods()
        return [
            p
            for p in pods
            if P.labels(p).get(const.LABEL_RESOURCE_KEY) == const.LABEL_RESOURCE_VALUE
        ]

    def labeled_pods(self) -> list[dict]:
        from .. import const

        try:
            pods = self._kubelet_pods()
        except RetryError:
            return self._fallback.labeled_pods()
        return [p for p in pods if const.LABEL_RESOURCE_KEY in P.labels(p)]

    def chip_state(self) -> tuple[dict[int, int], set[int]]:
        return _chip_state_from(self.labeled_pods())
