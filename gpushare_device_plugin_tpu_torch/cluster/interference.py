"""Co-tenant interference detection: correlating card co-residency with
decode-step p99 inflation.

Counterpart of ``gpushare_device_plugin_tpu/cluster/interference.py``: the
same detector, gauges and node annotation.

Two pods sharing one card only partition its memory; compute contention
between them is invisible to every accounting layer. The serving engines
measure their own decode-step latency (``serving/profiler.py``); this
module supplies the attribution: which card, which victim, which
aggressor, how bad.

1. **Residency**: per card, the resident share pods and their declared
   workload classes (``tpushare.aliyun.com/workload-class``), from the
   maintained ``NodeChipUsage`` index (:meth:`PodInformer.chip_residency`)
   or :func:`residency_from_pods` over any pod list.
2. **Solo baseline**: while a pod is the only resident on every card it
   occupies, its rolling step p99 feeds an EWMA baseline.
3. **Verdict**: while a latency-critical pod shares a card, its current
   step p99 over its solo baseline is the interference ratio, exported for
   every co-resident aggressor as
   ``tpushare_interference_ratio{chip,victim,aggressor}``. Ratios at or
   above ``threshold`` are flagged in the ``tpushare.aliyun.com/interference``
   node annotation the inspect CLI (and its ``top`` view) renders.

The detector never acts: the best-effort governor (``serving/governor.py``)
reacts to the SLO burn signal.

Lock discipline (``cluster.interference``, rank 63): inputs are gathered
before the detector lock is taken and gauges publish after it is dropped.
Stdlib only (the daemon scrapes ``/metrics`` with ``urllib``).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Iterable, Mapping

from .. import const
from . import pods as P
from ..utils.lockrank import make_lock
from ..utils.log import get_logger
from ..utils.metrics import MetricsRegistry, REGISTRY
from ..utils.metric_catalog import (
    ENGINE_STEP_P99_SECONDS as STEP_P99_GAUGE,
    INTERFERENCE_RATIO as RATIO_GAUGE,
)

log = get_logger("cluster.interference")

RATIO_HELP = (
    "Victim decode-step p99 over its solo-window baseline while sharing "
    "its chip with the aggressor (1.0 = no inflation; 0 = pair no longer "
    "co-resident)"
)

# Step-p99 gauge the serving engines export (serving/profiler.py); the
# detector's default signal source reads it back off the registry.

# Passes a known pod may be absent from residency before its baseline is
# pruned: tolerates a brief informer flap without forgetting solo state,
# while bounding both memory under churn and how long a recreated
# same-name pod could inherit a dead pod's baseline (~3 intervals).
_PRUNE_AFTER_ABSENT = 3


def step_p99s_from_urls(
    urls: Iterable[str], timeout_s: float = 5.0
) -> dict[str, float]:
    """Scrape the engines' ``tpushare_engine_step_p99_seconds`` gauges
    from ``/metrics`` endpoints (the serving pods' ``--metrics-port``) —
    the daemon-side signal source when the engines do NOT share the
    daemon's process registry. Stdlib-only (the daemon must not grow a
    requests dependency); unreachable endpoints are skipped, partial
    telemetry beats none (same policy as the CLI's scrapers)."""
    import urllib.request

    out: dict[str, float] = {}
    for url in urls:
        full = url.rstrip("/")
        if not full.endswith("/metrics"):
            full += "/metrics"
        try:
            with urllib.request.urlopen(full, timeout=timeout_s) as resp:
                text = resp.read().decode("utf-8", "replace")
        except (OSError, ValueError) as e:
            log.v(4, "interference: scrape of %s failed (%s)", full, e)
            continue
        for line in text.splitlines():
            if not line.startswith(STEP_P99_GAUGE):
                continue
            try:
                metric, value = line.rsplit(None, 1)
                val = float(value)
            except ValueError:
                continue
            pod = ""
            if "{" in metric:
                _, raw = metric.split("{", 1)
                for part in raw.rstrip("}").split(","):
                    if "=" in part:
                        k, v = part.split("=", 1)
                        if k.strip() == "pod":
                            pod = v.strip().strip('"').replace('\\"', '"')
            if pod:
                out[pod] = val
    return out


def residency_from_pods(
    pods: Iterable[Mapping[str, Any]],
) -> dict[int, dict[str, str]]:
    """Per-chip residency: chip index -> {"ns/name": workload class} for
    every active, assigned share pod (gang pods reside on every member
    chip). The pure-function twin of :meth:`NodeChipUsage.residency`,
    for list-backed pod sources and tests."""
    out: dict[int, dict[str, str]] = {}
    for pod in pods:
        if not P.is_active(pod) or not P.is_assigned(pod):
            continue
        if P.labels(pod).get(const.LABEL_RESOURCE_KEY) != const.LABEL_RESOURCE_VALUE:
            continue
        gang = P.gang_usage_by_chip(pod)
        chips = list(gang) if gang else []
        if not chips:
            idx = P.chip_idx_from_annotation(pod)
            if idx < 0:
                continue
            chips = [idx]
        key = f"{P.namespace(pod)}/{P.name(pod)}"
        cls = P.workload_class(pod)
        for idx in chips:
            out.setdefault(idx, {})[key] = cls
    return out


@dataclasses.dataclass(frozen=True)
class InterferenceReport:
    """One victim's verdict on one chip for the current pass."""

    chip: int
    victim: str  # "ns/name"
    victim_class: str
    aggressors: tuple[str, ...]
    ratio: float  # current p99 / solo baseline p99
    victim_p99: float
    baseline_p99: float
    flagged: bool  # ratio >= detector threshold

    def to_dict(self) -> dict[str, Any]:
        return {
            "victim": self.victim,
            "victim_class": self.victim_class,
            "aggressors": list(self.aggressors),
            "ratio": round(self.ratio, 3),
            "victim_p99_s": round(self.victim_p99, 6),
            "baseline_p99_s": round(self.baseline_p99, 6),
            "flagged": self.flagged,
        }


class InterferenceDetector:
    """Correlates residency with step-p99 inflation against solo baselines.

    ``threshold`` flags a verdict (annotation + ``flagged``);
    ``baseline_alpha`` is the solo-window EWMA weight of the newest
    sample. Baselines persist across co-residency episodes — the whole
    point is remembering what solo looked like once a co-tenant lands.
    """

    def __init__(
        self,
        *,
        threshold: float = 1.25,
        baseline_alpha: float = 0.3,
        baseline_cooldown_passes: int = 2,
        registry: MetricsRegistry | None = None,
    ) -> None:
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        if not 0.0 < baseline_alpha <= 1.0:
            raise ValueError(
                f"baseline_alpha must be in (0, 1], got {baseline_alpha}"
            )
        if baseline_cooldown_passes < 1:
            raise ValueError(
                f"baseline_cooldown_passes must be >= 1, got "
                f"{baseline_cooldown_passes}"
            )
        self.threshold = threshold
        self._alpha = baseline_alpha
        self._cooldown = baseline_cooldown_passes
        self._reg = registry if registry is not None else REGISTRY
        self._lock = make_lock("cluster.interference")
        self._baseline: dict[str, float] = {}  # pod key -> solo p99 EWMA
        # consecutive passes each pod has been solo: the exported step
        # p99 is a ROLLING window that lags residency, so the first
        # solo passes after a co-residency episode still carry the
        # contended tail — absorbing them would inflate the baseline
        # and mask the next episode (upward updates wait out the
        # cooldown; a LOWER p99 is always safe to absorb immediately)
        self._solo_streak: dict[str, int] = {}
        # consecutive passes a known pod has been ABSENT from residency:
        # after _PRUNE_AFTER_ABSENT passes its baseline is dropped, so
        # the tables stay bounded under pod churn and a recreated pod
        # with the same ns/name (possibly a very different model) cannot
        # inherit a dead pod's baseline and fake a verdict
        self._absent: dict[str, int] = {}
        self._reports: list[InterferenceReport] = []
        self._exported: set[tuple[str, str, str]] = set()  # (chip, victim, aggressor)
        self._passes = 0

    # --- introspection ----------------------------------------------------

    def baseline(self, pod_key: str) -> float | None:
        with self._lock:
            return self._baseline.get(pod_key)

    def reports(self) -> list[InterferenceReport]:
        """The last pass's verdicts (CLI/annotation raw material)."""
        with self._lock:
            return list(self._reports)

    # --- the pass ---------------------------------------------------------

    @staticmethod
    def _p99_for(
        step_p99: Mapping[str, float], pod_key: str
    ) -> float | None:
        """The pod's exported step p99: exact ``ns/name`` label first,
        then the bare pod name (an engine that only knows its own name
        exports that — same fallback as the CLI's ``engine_row_for``)."""
        v = step_p99.get(pod_key)
        if v is None:
            _, _, bare = pod_key.partition("/")
            v = step_p99.get(bare)
        return v

    def observe(
        self,
        residency: Mapping[int, Mapping[str, str]],
        step_p99: Mapping[str, float],
    ) -> list[InterferenceReport]:
        """One detector pass over gathered inputs (no I/O, no other
        locks): update solo baselines, compute co-residency verdicts,
        export ratio gauges. Returns the pass's reports."""
        # chips each pod resides on (a gang victim is solo only when
        # EVERY member chip is exclusively its own)
        chips_of: dict[str, list[int]] = {}
        for chip, tenants in residency.items():
            for key in tenants:
                chips_of.setdefault(key, []).append(chip)
        solo = {
            key for key, chips in chips_of.items()
            if all(len(residency[c]) == 1 for c in chips)
        }
        reports: list[InterferenceReport] = []
        exported: set[tuple[str, str, str]] = set()
        gauge_rows: list[tuple[str, str, str, float]] = []
        with self._lock:
            self._passes += 1
            for key in chips_of:
                if key in solo:
                    self._solo_streak[key] = self._solo_streak.get(key, 0) + 1
                else:
                    self._solo_streak[key] = 0
                self._absent.pop(key, None)
            for key in set(self._baseline) | set(self._solo_streak):
                if key in chips_of:
                    continue
                gone = self._absent.get(key, 0) + 1
                if gone >= _PRUNE_AFTER_ABSENT:
                    self._baseline.pop(key, None)
                    self._solo_streak.pop(key, None)
                    self._absent.pop(key, None)
                else:
                    self._absent[key] = gone
            for key in solo:
                p99 = self._p99_for(step_p99, key)
                if p99 is None or p99 <= 0:
                    continue
                prev = self._baseline.get(key)
                if prev is not None and p99 < prev:
                    # downward is always safe: a lower p99 cannot be a
                    # contention artifact
                    self._baseline[key] = prev + self._alpha * (p99 - prev)
                    continue
                if self._solo_streak.get(key, 0) < self._cooldown:
                    # the rolling p99 window still carries the last
                    # episode's contended tail — wait it out before
                    # seeding or raising the solo baseline
                    continue
                self._baseline[key] = (
                    p99 if prev is None
                    else prev + self._alpha * (p99 - prev)
                )
            for chip, tenants in sorted(residency.items()):
                if len(tenants) < 2:
                    continue
                for victim, cls in sorted(tenants.items()):
                    if cls != const.WORKLOAD_LATENCY_CRITICAL:
                        continue
                    base = self._baseline.get(victim)
                    p99 = self._p99_for(step_p99, victim)
                    if base is None or base <= 0 or p99 is None or p99 <= 0:
                        continue
                    ratio = p99 / base
                    aggressors = tuple(
                        sorted(k for k in tenants if k != victim)
                    )
                    reports.append(
                        InterferenceReport(
                            chip=chip, victim=victim, victim_class=cls,
                            aggressors=aggressors, ratio=ratio,
                            victim_p99=p99, baseline_p99=base,
                            flagged=ratio >= self.threshold,
                        )
                    )
                    for agg in aggressors:
                        pair = (str(chip), victim, agg)
                        exported.add(pair)
                        gauge_rows.append((*pair, ratio))
            # Zero ONLY pairs actually gone from residency ("resolved").
            # A pair still co-resident but without a verdict this pass
            # (scrape miss, engine restart mid-re-export, pruned
            # baseline) keeps its last exported ratio: losing the signal
            # is not the same as the episode ending, and zeroing it
            # would read as resolved — and flap on flaky scrapes.
            live_pairs = {
                (str(chip), victim, agg)
                for chip, tenants in residency.items()
                for victim in tenants
                for agg in tenants
                if agg != victim
            }
            carried = (self._exported - exported) & live_pairs
            for stale in self._exported - exported - carried:
                gauge_rows.append((*stale, 0.0))
            self._exported = exported | carried
            self._reports = reports
        for chip, victim, aggressor, ratio in gauge_rows:
            self._reg.gauge_set(
                RATIO_GAUGE, ratio, RATIO_HELP,
                chip=chip, victim=victim, aggressor=aggressor,
            )
        return reports

    # --- annotation surface ------------------------------------------------

    def annotation_doc(self, now_unix: float | None = None) -> dict[str, Any]:
        """The node-annotation document for the last pass: per chip, the
        WORST victim verdict (the CLI renders one row per chip)."""
        worst: dict[int, InterferenceReport] = {}
        for r in self.reports():
            cur = worst.get(r.chip)
            if cur is None or r.ratio > cur.ratio:
                worst[r.chip] = r
        return {
            "time_unix": time.time() if now_unix is None else now_unix,
            "threshold": self.threshold,
            "chips": {str(c): r.to_dict() for c, r in sorted(worst.items())},
        }


def interference_from_node(
    node: Mapping[str, Any] | None,
) -> dict[str, Any] | None:
    """Parse the interference node annotation
    (:data:`~..const.ANN_INTERFERENCE`); None when absent/garbled — the
    inspect CLI's read side of :meth:`InterferenceLoop.publish`. Chip
    rows are coerced (garbled ratios read as 0.0) so callers can format
    without re-validating."""
    if not node:
        return None
    raw = ((node.get("metadata") or {}).get("annotations") or {}).get(
        const.ANN_INTERFERENCE
    )
    if not raw:
        return None
    try:
        doc = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    chips_raw = doc.get("chips")
    chips: dict[str, dict[str, Any]] = {}
    if isinstance(chips_raw, dict):
        for c, row in chips_raw.items():
            if not isinstance(row, dict):
                continue
            try:
                ratio = float(row.get("ratio", 0.0))
            except (TypeError, ValueError):
                ratio = 0.0
            aggs = row.get("aggressors")
            chips[str(c)] = {
                "victim": str(row.get("victim", "") or ""),
                "aggressors": [str(a) for a in aggs]
                if isinstance(aggs, list) else [],
                "ratio": ratio,
                "flagged": bool(row.get("flagged")),
            }
    try:
        threshold = float(doc.get("threshold", 0.0))
    except (TypeError, ValueError):
        threshold = 0.0
    try:
        # kept so consumers (and -o json) can judge verdict staleness —
        # a dead detector leaves its last annotation behind forever
        time_unix = float(doc.get("time_unix", 0.0))
    except (TypeError, ValueError):
        time_unix = 0.0
    return {"chips": chips, "threshold": threshold, "time_unix": time_unix}


class InterferenceLoop:
    """The daemon's detector loop: every ``interval_s`` it gathers
    residency (pod source) + step p99s (metrics registry), runs one
    detector pass, and publishes the interference node annotation
    best-effort — the same scan/publish shape as
    :class:`~..allocator.defrag.DefragLoop`.

    The signal source, in precedence order: an explicit ``step_p99_fn``
    (tests, custom pipelines), then ``scrape_urls`` (the serving pods'
    ``/metrics`` endpoints — the deployment where engines run in their
    own containers and the daemon's registry never sees their gauges),
    then the shared in-process registry's
    ``tpushare_engine_step_p99_seconds`` series (engines co-located in
    the daemon process — benches, tests, single-process integrations)."""

    def __init__(
        self,
        detector: InterferenceDetector,
        api: Any,
        node_name: str,
        pod_source: Any,
        *,
        interval_s: float = 30.0,
        step_p99_fn: Callable[[], Mapping[str, float]] | None = None,
        scrape_urls: Iterable[str] | None = None,
        registry: MetricsRegistry | None = None,
    ) -> None:
        self._detector = detector
        self._api = api
        self._node = node_name
        self._pods = pod_source
        self._interval = interval_s
        self._reg = registry if registry is not None else REGISTRY
        self._step_fn = step_p99_fn
        self._scrape_urls = list(scrape_urls or ())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "InterferenceLoop":
        self._thread = threading.Thread(
            target=self._run, name="interference-loop", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — never kill the loop
                log.warning("interference pass failed: %s", e)

    def _step_p99s(self) -> Mapping[str, float]:
        if self._step_fn is not None:
            return self._step_fn()
        if self._scrape_urls:
            return step_p99s_from_urls(self._scrape_urls)
        out: dict[str, float] = {}
        for labels, value in self._reg.gauge_series(STEP_P99_GAUGE).items():
            pod = dict(labels).get("pod", "")
            if pod:
                out[pod] = value
        return out

    def run_once(self) -> list[InterferenceReport]:
        """One gather-observe-publish pass (callable directly in tests).

        Residency comes from the pod source's incrementally-maintained
        per-chip index when it has one (``PodInformer.chip_residency``,
        backed by ``NodeChipUsage`` — same membership predicates), else
        from a fresh :func:`residency_from_pods` over the labeled pods
        (list/kubelet-backed sources)."""
        fn = getattr(self._pods, "chip_residency", None)
        if callable(fn):
            residency = fn()
        else:
            residency = residency_from_pods(self._pods.labeled_pods())
        reports = self._detector.observe(residency, self._step_p99s())
        self.publish()
        return reports

    def publish(self) -> None:
        """Write the interference node annotation (best effort — the
        apiserver is the database, the CLI needs no extra endpoint)."""
        doc = self._detector.annotation_doc()
        try:
            self._api.patch_node(
                self._node,
                {"metadata": {"annotations": {
                    const.ANN_INTERFERENCE: json.dumps(doc, sort_keys=True)
                }}},
            )
        except Exception as e:  # noqa: BLE001 — status is observability
            log.v(4, "interference: annotation publish failed (%s)", e)
