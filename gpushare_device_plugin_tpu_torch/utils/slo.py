"""SLO error budgets with multi-window burn-rate alerting.

Counterpart of ``gpushare_device_plugin_tpu/utils/slo.py``. Each tier's
**error budget** is the fraction of requests its objective allows to
miss; the **burn rate** over a window is the observed miss fraction over
that allowance. Two windows must burn together (the SRE workbook's
multi-window scheme):

- **page**: burn >= ``page_burn`` (14.4) over the 1 h window and the
  5 m window;
- **warn**: burn >= ``warn_burn`` (6.0) over the 6 h window and the 1 h
  window.

:meth:`SloBudget.record` drops each verdict into a bucketed ring (O(1)),
:meth:`SloBudget.evaluate` sums the windows, and :meth:`SloBudget.publish`
exports ``tpushare_slo_burn_rate{tier,window}``,
``tpushare_slo_error_budget_remaining{tier}`` and
``tpushare_slo_severity{tier}``. Entering page severity fires the hook
once per episode. The best-effort governor (``serving/governor.py``)
polls :meth:`SloBudget.severity` as its engage signal.

The clock is injectable: windows are seconds on whatever monotonic clock
the caller gives, so tests drive hours of history in microseconds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from .lockrank import make_lock
from .metric_catalog import SLO_BURN_RATE, SLO_ERROR_BUDGET_REMAINING, SLO_SEVERITY
from .metrics import REGISTRY, MetricsRegistry

SEVERITY_PAGE = "page"
SEVERITY_WARN = "warn"

FAST_WINDOW_S = 300.0  # 5 m: is it still happening
MID_WINDOW_S = 3600.0  # 1 h: page-grade consumption
SLOW_WINDOW_S = 21600.0  # 6 h: warn-grade consumption

DEFAULT_PAGE_BURN = 14.4
DEFAULT_WARN_BURN = 6.0


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One tier's objective: the fraction ``goal`` of requests that must
    meet their targets (the targets ride on each request). ``1 - goal``
    is the error budget."""

    tier: str
    goal: float = 0.99

    def __post_init__(self) -> None:
        if not 0.0 < self.goal < 1.0:
            raise ValueError(
                f"goal must be in (0, 1), got {self.goal} — 1.0 leaves "
                "zero error budget and every miss pages"
            )

    @property
    def budget_fraction(self) -> float:
        return 1.0 - self.goal


@dataclasses.dataclass
class _TierState:
    objective: SloObjective
    good: list[int]
    bad: list[int]
    newest_bucket: int  # absolute index of the ring's newest position
    paging: bool = False  # the page hook fires on entry only
    seq: int = 0  # bumped per record: invalidates the severity cache
    # (now_bucket, seq, verdict): polls between records in one bucket
    # are O(1)
    cached: "tuple[int, int, TierVerdict] | None" = None


@dataclasses.dataclass(frozen=True)
class TierVerdict:
    """One tier's evaluated budget."""

    tier: str
    severity: str | None  # SEVERITY_PAGE | SEVERITY_WARN | None
    burn_5m: float
    burn_1h: float
    burn_6h: float
    budget_remaining: float  # of the 6 h window's budget, in [0, 1]
    requests_6h: int

    def to_dict(self) -> dict[str, Any]:
        return {
            "tier": self.tier,
            "severity": self.severity,
            "burn_5m": round(self.burn_5m, 3),
            "burn_1h": round(self.burn_1h, 3),
            "burn_6h": round(self.burn_6h, 3),
            "budget_remaining": round(self.budget_remaining, 4),
            "requests_6h": self.requests_6h,
        }


class SloBudget:
    """Per-tier error budgets over a ring of verdicts in ``bucket_s``
    buckets (10 s: the 6 h window is 2,160 buckets a tier)."""

    def __init__(
        self,
        objectives: dict[str, SloObjective] | None = None,
        *,
        bucket_s: float = 10.0,
        page_burn: float = DEFAULT_PAGE_BURN,
        warn_burn: float = DEFAULT_WARN_BURN,
        clock: Callable[[], float] = time.monotonic,
        on_page: Callable[[str, TierVerdict], None] | None = None,
    ) -> None:
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {bucket_s}")
        self._bucket_s = bucket_s
        self._n_buckets = int(SLOW_WINDOW_S // bucket_s) + 1
        self._page_burn = page_burn
        self._warn_burn = warn_burn
        self._clock = clock
        self._on_page = on_page
        self._lock = make_lock("slo.budget")
        self._tiers: dict[str, _TierState] = {}
        # A budget given objectives tracks only those tiers; one given none
        # tracks every tier it sees at the default goal.
        self._auto_tiers = not objectives
        for obj in (objectives or {}).values():
            self._ensure(obj.tier, obj)

    def _ensure(self, tier: str, objective: SloObjective | None = None) -> _TierState | None:
        state = self._tiers.get(tier)
        if state is None:
            if objective is None and not self._auto_tiers:
                return None
            state = _TierState(
                objective=objective or SloObjective(tier=tier),
                good=[0] * self._n_buckets,
                bad=[0] * self._n_buckets,
                newest_bucket=int(self._clock() / self._bucket_s),
            )
            self._tiers[tier] = state
        return state

    def _advance(self, state: _TierState, bucket: int) -> None:
        """Zero the ring between the newest bucket seen and ``bucket``
        (lock held)."""
        gap = bucket - state.newest_bucket
        if gap <= 0:
            return
        for i in range(1, min(gap, self._n_buckets) + 1):
            pos = (state.newest_bucket + i) % self._n_buckets
            state.good[pos] = 0
            state.bad[pos] = 0
        state.newest_bucket = bucket

    def record(self, tier: str, ok: bool, now: float | None = None) -> None:
        """One request's verdict. A tier a configured budget never
        declared is dropped."""
        t = self._clock() if now is None else now
        bucket = int(t / self._bucket_s)
        with self._lock:
            state = self._ensure(tier)
            if state is None:
                return
            self._advance(state, bucket)
            pos = bucket % self._n_buckets
            if ok:
                state.good[pos] += 1
            else:
                state.bad[pos] += 1
            state.seq += 1

    def _window_counts(self, state: _TierState, window_s: float,
                       now_bucket: int) -> tuple[int, int]:
        """(good, bad) within the trailing ``window_s`` (lock held)."""
        n = min(int(window_s // self._bucket_s) + 1, self._n_buckets)
        good = bad = 0
        for i in range(n):
            bucket = now_bucket - i
            if bucket < 0:
                break
            if bucket <= state.newest_bucket - self._n_buckets:
                break  # fell off the ring
            if bucket > state.newest_bucket:
                continue  # not advanced yet: stale data
            pos = bucket % self._n_buckets
            good += state.good[pos]
            bad += state.bad[pos]
        return good, bad

    @staticmethod
    def _burn(good: int, bad: int, budget_fraction: float) -> float:
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / budget_fraction

    def _tier_verdict(self, tier: str, state: _TierState, now_bucket: int) -> TierVerdict:
        bf = state.objective.budget_fraction
        g5, b5 = self._window_counts(state, FAST_WINDOW_S, now_bucket)
        g1, b1 = self._window_counts(state, MID_WINDOW_S, now_bucket)
        g6, b6 = self._window_counts(state, SLOW_WINDOW_S, now_bucket)
        burn_5m = self._burn(g5, b5, bf)
        burn_1h = self._burn(g1, b1, bf)
        burn_6h = self._burn(g6, b6, bf)
        severity: str | None = None
        if burn_1h >= self._page_burn and burn_5m >= self._page_burn:
            severity = SEVERITY_PAGE
        elif burn_6h >= self._warn_burn and burn_1h >= self._warn_burn:
            severity = SEVERITY_WARN
        allowed = (g6 + b6) * bf
        remaining = 1.0 if allowed <= 0 else max(0.0, 1.0 - b6 / allowed)
        return TierVerdict(tier=tier, severity=severity, burn_5m=burn_5m, burn_1h=burn_1h,
                           burn_6h=burn_6h, budget_remaining=remaining, requests_6h=g6 + b6)

    def _update_paging(self, state: _TierState, verdict: TierVerdict) -> bool:
        """Latch the episode flag (lock held); True when the tier just
        entered page severity."""
        if verdict.severity == SEVERITY_PAGE and not state.paging:
            state.paging = True
            return True
        if verdict.severity != SEVERITY_PAGE and state.paging:
            state.paging = False
        return False

    def evaluate(self, now: float | None = None) -> dict[str, TierVerdict]:
        """Every tier's burn rates and severity; fires the page hook,
        outside the lock, for tiers that just entered page severity."""
        t = self._clock() if now is None else now
        now_bucket = int(t / self._bucket_s)
        verdicts: dict[str, TierVerdict] = {}
        newly_paging: list[TierVerdict] = []
        with self._lock:
            for tier, state in self._tiers.items():
                self._advance(state, now_bucket)
                verdict = self._tier_verdict(tier, state, now_bucket)
                state.cached = (now_bucket, state.seq, verdict)
                verdicts[tier] = verdict
                if self._update_paging(state, verdict):
                    newly_paging.append(verdict)
        if self._on_page is not None:
            for verdict in newly_paging:
                self._on_page(verdict.tier, verdict)
        return verdicts

    def severity(self, tier: str, now: float | None = None) -> str | None:
        """One tier's severity, the governor's engage signal; cached per
        (bucket, record count), so polls between records are O(1)."""
        t = self._clock() if now is None else now
        now_bucket = int(t / self._bucket_s)
        fire: TierVerdict | None = None
        with self._lock:
            state = self._tiers.get(tier)
            if state is None:
                return None
            cached = state.cached
            if cached is not None and cached[0] == now_bucket and cached[1] == state.seq:
                return cached[2].severity
            self._advance(state, now_bucket)
            verdict = self._tier_verdict(tier, state, now_bucket)
            state.cached = (now_bucket, state.seq, verdict)
            if self._update_paging(state, verdict):
                fire = verdict
        if fire is not None and self._on_page is not None:
            self._on_page(fire.tier, fire)
        return verdict.severity

    def set_on_page(self, hook: Callable[[str, TierVerdict], None] | None) -> None:
        """(Re)register the page-entry hook."""
        self._on_page = hook

    def publish(self, registry: MetricsRegistry | None = None, now: float | None = None,
                **labels: str) -> dict[str, TierVerdict]:
        """Evaluate, and export every tier's budget as gauges."""
        reg = registry if registry is not None else REGISTRY
        verdicts = self.evaluate(now)
        for tier, v in verdicts.items():
            for window, burn in (("5m", v.burn_5m), ("1h", v.burn_1h), ("6h", v.burn_6h)):
                reg.gauge_set(
                    SLO_BURN_RATE, burn,
                    "Error-budget burn rate (miss fraction / allowed miss "
                    "fraction) over the trailing window",
                    tier=tier, window=window, **labels,
                )
            reg.gauge_set(
                SLO_ERROR_BUDGET_REMAINING, v.budget_remaining,
                "Fraction of the 6h window's error budget still unspent",
                tier=tier, **labels,
            )
            reg.gauge_set(
                SLO_SEVERITY,
                2.0 if v.severity == SEVERITY_PAGE else 1.0 if v.severity == SEVERITY_WARN else 0.0,
                "Multi-window burn-rate severity (0 ok, 1 warn, 2 page)",
                tier=tier, **labels,
            )
        return verdicts
