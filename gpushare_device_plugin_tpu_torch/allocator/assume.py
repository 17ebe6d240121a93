"""In-flight claim ledger (the assume-cache), cut to its claims.

Counterpart of ``gpushare_device_plugin_tpu/allocator/assume.py``. The
reference's ledger also carries the allocators' chip reservations and
their overlay transaction; the port's only user is the KV handoff's mover,
which claims a handoff key for the length of one journaled handoff so a
concurrent mover skips it, and the crash resolver, which releases a key
nobody claims. So this copy keeps :meth:`AssumeCache.claim`,
:meth:`~AssumeCache.is_claimed`, :meth:`~AssumeCache.release` and
:meth:`~AssumeCache.release_if_unclaimed`.

Every claim carries a monotonic stamp and a TTL (``ttl_s``): a claim whose
owner died mid-protocol expires, and the next :meth:`~AssumeCache.claim`
of its key reaps it instead of finding the key stranded forever.
"""

from __future__ import annotations

import time
from typing import Callable

from ..utils.lockrank import make_rlock
from ..utils.metric_catalog import ASSUME_EXPIRED_TOTAL as EXPIRED_METRIC
from ..utils.metrics import REGISTRY

PodKey = tuple[str, str]  # (namespace, name)

EXPIRED_HELP = (
    "Claims/reservations released by TTL expiry — an owner (a hung PATCH, "
    "a crashed worker) held them past the deadline; capacity was unstranded"
)

DEFAULT_TTL_S = 300.0


class AssumeCache:
    def __init__(
        self,
        ttl_s: float = DEFAULT_TTL_S,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = make_rlock("allocator.ledger")
        self._ttl = ttl_s
        self._clock = clock
        self._claimed: dict[PodKey, float] = {}  # key -> stamp

    def claim(self, key: PodKey) -> bool:
        """Mark ``key`` as in flight; False if already claimed (by a live
        owner — an expired claim is reaped and re-claimable)."""
        with self._lock:
            now = self._clock()
            stamp = self._claimed.get(key)
            if stamp is not None:
                if now - stamp <= self._ttl:
                    return False
                self._release_expired(key, "claim")
            self._claimed[key] = now
            return True

    def is_claimed(self, key: PodKey) -> bool:
        with self._lock:
            stamp = self._claimed.get(key)
            return stamp is not None and self._clock() - stamp <= self._ttl

    def release(self, key: PodKey) -> None:
        """Drop the claim for ``key``."""
        with self._lock:
            self._claimed.pop(key, None)

    def release_if_unclaimed(self, key: PodKey) -> bool:
        """Atomic check-and-release for a resolver: a claimed key is a live
        protocol mid-flight and keeps its claim. True when released."""
        with self._lock:
            if self.is_claimed(key):
                return False
            self.release(key)
            return True

    def _release_expired(self, key: PodKey, kind: str) -> None:
        """Caller must hold self._lock."""
        self._claimed.pop(key, None)
        REGISTRY.counter_inc(EXPIRED_METRIC, EXPIRED_HELP, kind=kind)
