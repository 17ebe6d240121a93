"""Pluggable placement policies behind one registration point.

Counterpart of ``gpushare_device_plugin_tpu/extender/policy.py``, copied
whole; it is the port's only ``extender`` module (the rest of the
extender is the reference's control plane). A policy sees one
candidate's placement evidence (:class:`PolicyView`: the decisive chip's
free units, the node's whole free vector, for gang slices the topology
objective components, and for fleet routing the prefix pages the
candidate engine already caches) and answers with a
:class:`~..utils.decisions.ScoreVector`. The decision records flow from
that one answer, so a swapped policy is fully introspectable.

The policies:

- ``greedy-binpack``: the slack-minimizing binpack (raw = 10*(1-slack)
  on the tightest feasible chip). Also the implementation behind the
  legacy ``best-fit`` / ``first-fit`` / ``spread`` names; the fleet's
  affinity-blind control runs ``spread``.
- ``multi-objective``: a weighted composite over packing slack, node
  balance and the gang topology objectives (ICI hops, stranded slivers,
  broken whole chips): one scalar to rank, the components kept in the
  vector.
- ``learned``: a stub for a trained policy: a fixed linear model over the
  same feature vector a trained policy would consume. It pins the
  registration point and the feature contract.
- ``prefix-affinity``: the fleet router's default: radix-prefix overlap
  tempered by headroom.

``register_policy`` is the one extension point.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..utils.decisions import ScoreVector, chip_breakdown


@dataclasses.dataclass(frozen=True)
class PolicyView:
    """One placement candidate, as a policy sees it.

    ``free_units``/``chip`` describe the decisive chip (the tightest or
    roomiest feasible one, or the concretely chosen one at bind time);
    ``free_vector`` is every feasible chip's free units on the node (for
    policies that weigh balance, not just the decisive chip). Gang
    candidates add the winning slice's topology objective components;
    single-chip candidates leave them None.
    """

    free_units: int
    capacity: int
    request_units: int
    free_vector: tuple[int, ...] = ()
    chip: int | None = None
    ici_hops: int | None = None
    stranded: int | None = None
    broken: int | None = None
    tie_break: int | None = None
    # Fleet routing candidates (serving.router) add the number of radix
    # pages the candidate engine already holds for the request's prompt
    # prefix; placement candidates leave it None.
    affinity_pages: int | None = None

    def slack(self) -> float:
        """Leftover fraction on the decisive chip after placement."""
        if self.capacity <= 0:
            return 0.0
        return (self.free_units - self.request_units) / self.capacity


class PlacementPolicy:
    """One placement policy: ``score(view) -> ScoreVector``.

    ``chip_policy`` names the chip-SELECTION semantics reused from the
    binpack allocator ("best-fit" | "first-fit" | "spread") — which chip
    on a feasible node is decisive, and which chip a bind concretely
    takes. Scoring (this class) ranks candidates; selection stays with
    ``allocator.binpack.assign_chip`` so the extender's decisions and
    the device plugin's re-validation never disagree about which chip a
    score was about.
    """

    name = "base"
    chip_policy = "best-fit"

    def score(self, view: PolicyView) -> ScoreVector:
        raise NotImplementedError

    def _infeasible(self, view: PolicyView) -> ScoreVector:
        return ScoreVector(
            policy=self.name, raw=0.0,
            free_units=max(0, view.free_units),
            request_units=view.request_units, binpack=0.0,
            ici_hops=view.ici_hops, stranded=view.stranded,
            broken=view.broken, tie_break=view.tie_break,
        )


class GreedyBinpackPolicy(PlacementPolicy):
    """Slack-minimizing binpack — the repo's historical scorer.

    Delegates to :func:`chip_breakdown` (THE shared formula the
    allocator's provenance records also use) and carries the gang slice
    components through unchanged, so ``greedy-binpack`` — and the legacy
    ``best-fit``/``first-fit``/``spread`` names, which are this class
    with a different ``chip_policy`` — project bit-identical wire scores
    to the pre-registry code."""

    name = "greedy-binpack"

    def __init__(self, chip_policy: str = "best-fit") -> None:
        self.chip_policy = chip_policy

    def score(self, view: PolicyView) -> ScoreVector:
        base = chip_breakdown(
            view.free_units, view.capacity, view.chip,
            view.request_units, self.chip_policy,
        )
        if (
            base.policy == self.name
            and view.ici_hops is None
            and view.stranded is None
            and view.broken is None
            and view.tie_break is None
        ):
            return base  # the 1k-nodes-per-verb hot path: no copy
        return dataclasses.replace(
            base, policy=self.name,
            ici_hops=view.ici_hops, stranded=view.stranded,
            broken=view.broken,
            tie_break=(view.tie_break if view.tie_break is not None
                       else base.tie_break),
        )


class _LegacyPolicy(GreedyBinpackPolicy):
    """The pre-registry policy names. ``ScoreVector.policy`` keeps the
    legacy name (pinned by the existing verb and provenance tests)."""

    def __init__(self, chip_policy: str) -> None:
        super().__init__(chip_policy)
        self.name = chip_policy


class MultiObjectivePolicy(PlacementPolicy):
    """Weighted composite: packing slack + node balance + gang topology
    objectives, normalized to the same 0-10 raw scale.

    The gang terms convert the lexicographic ``topology.best_slice``
    objective into graded penalties so two nodes whose best slices
    differ only in ICI diameter or stranded slivers rank apart instead
    of tying at the wire scale. Weights are constructor arguments — a
    deployment tunes them, the vector records the outcome."""

    name = "multi-objective"

    def __init__(
        self,
        w_pack: float = 0.55,
        w_balance: float = 0.15,
        w_hops: float = 0.15,
        w_stranded: float = 0.1,
        w_broken: float = 0.05,
    ) -> None:
        self._w = (w_pack, w_balance, w_hops, w_stranded, w_broken)

    def score(self, view: PolicyView) -> ScoreVector:
        if view.capacity <= 0 or view.free_units < view.request_units:
            return self._infeasible(view)
        w_pack, w_balance, w_hops, w_stranded, w_broken = self._w
        slack = view.slack()
        pack = 1.0 - slack
        # balance: how evenly the REST of the node's feasible chips sit —
        # a node whose other chips are near-full is a better consolidation
        # target than one we would newly fragment.
        vec = view.free_vector or (view.free_units,)
        cap = float(view.capacity)
        balance = 1.0 - (sum(vec) / (cap * len(vec)))
        hops = view.ici_hops if view.ici_hops is not None else 0
        stranded = view.stranded if view.stranded is not None else 0
        broken = view.broken if view.broken is not None else 0
        hop_term = 1.0 / (1.0 + hops)
        stranded_term = 1.0 - min(1.0, stranded / cap)
        broken_term = 1.0 / (1.0 + broken)
        raw = 10.0 * (
            w_pack * pack
            + w_balance * balance
            + w_hops * hop_term
            + w_stranded * stranded_term
            + w_broken * broken_term
        )
        return ScoreVector(
            policy=self.name, raw=max(0.0, min(10.0, raw)),
            free_units=view.free_units, request_units=view.request_units,
            binpack=slack, ici_hops=view.ici_hops, stranded=view.stranded,
            broken=view.broken, tie_break=view.tie_break,
        )


class LearnedStubPolicy(PlacementPolicy):
    """Registration-point stub for a trained placement policy.

    Scores with a fixed linear model over the feature vector a real
    RL policy would consume — (pack, balance,
    hop, stranded, broken), the same features ``multi-objective``
    weighs — so swapping in trained weights is a constructor argument,
    not a refactor. Deterministic by construction: same view, same
    score, no randomness."""

    name = "learned"

    # Stand-in "weights" (bias + 5 features). A trained policy replaces
    # these via the ``weights=`` ctor arg or a subclass registered under
    # its own name.
    DEFAULT_WEIGHTS = (0.5, 6.0, 1.0, 1.5, 0.7, 0.3)

    def __init__(self, weights: tuple[float, ...] | None = None) -> None:
        self._weights = tuple(weights or self.DEFAULT_WEIGHTS)
        if len(self._weights) != 6:
            raise ValueError("learned policy expects 6 weights (bias + 5)")

    def features(self, view: PolicyView) -> tuple[float, ...]:
        """The feature contract a trained policy consumes."""
        cap = float(view.capacity or 1)
        vec = view.free_vector or (view.free_units,)
        return (
            1.0 - view.slack(),
            1.0 - (sum(vec) / (cap * len(vec))),
            1.0 / (1.0 + (view.ici_hops or 0)),
            1.0 - min(1.0, (view.stranded or 0) / cap),
            1.0 / (1.0 + (view.broken or 0)),
        )

    def score(self, view: PolicyView) -> ScoreVector:
        if view.capacity <= 0 or view.free_units < view.request_units:
            return self._infeasible(view)
        bias, *ws = self._weights
        raw = bias + sum(w * f for w, f in zip(ws, self.features(view)))
        return ScoreVector(
            policy=self.name, raw=max(0.0, min(10.0, raw)),
            free_units=view.free_units, request_units=view.request_units,
            binpack=view.slack(), ici_hops=view.ici_hops,
            stranded=view.stranded, broken=view.broken,
            tie_break=view.tie_break,
        )


class PrefixAffinityPolicy(PlacementPolicy):
    """Fleet-router scorer: prefer the engine already holding the
    request's prompt prefix in its radix cache, tempered by headroom.

    ``view.affinity_pages`` carries how many prefix pages the candidate
    engine's exported fingerprint set matched; ``free_units``/``capacity``
    carry its admission headroom (free concurrency slots). The affinity
    term saturates (one long cached prefix should not outvote a nearly
    full engine forever) and the headroom term breaks ties among equally
    warm candidates, so the policy degrades to load balancing when no
    candidate holds the prefix — exactly the fall-back the router needs
    when fingerprints are stale or a scrape failed (affinity_pages=None
    scores the same as 0)."""

    name = "prefix-affinity"

    def __init__(self, w_affinity: float = 0.7, w_headroom: float = 0.3,
                 saturation_pages: int = 8) -> None:
        self._w_affinity = w_affinity
        self._w_headroom = w_headroom
        self._sat = max(1, saturation_pages)

    def score(self, view: PolicyView) -> ScoreVector:
        if view.capacity <= 0 or view.free_units < view.request_units:
            return self._infeasible(view)
        pages = view.affinity_pages or 0
        aff = min(1.0, pages / float(self._sat))
        headroom = view.free_units / float(view.capacity)
        raw = 10.0 * (self._w_affinity * aff + self._w_headroom * headroom)
        return ScoreVector(
            policy=self.name, raw=max(0.0, min(10.0, raw)),
            free_units=view.free_units, request_units=view.request_units,
            binpack=headroom, ici_hops=view.ici_hops,
            stranded=view.stranded, broken=view.broken,
            tie_break=(view.tie_break if view.tie_break is not None
                       else pages),
        )


# --- registry ---------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], PlacementPolicy]] = {}


def register_policy(name: str, factory: Callable[[], PlacementPolicy]) -> None:
    """Register ``factory`` under ``name`` (``--placement-policy`` values
    resolve here). Re-registration replaces — tests and downstream
    deployments may override the stubs."""
    _REGISTRY[name] = factory


def policy_names() -> list[str]:
    """Registered policy names (stable order for --help/docs)."""
    return sorted(_REGISTRY)


def get_policy(name: str) -> PlacementPolicy:
    """Resolve a policy name to an instance. Legacy chip-policy names
    (``best-fit``/``first-fit``/``spread``) resolve to the binpack
    scorer with matching selection semantics — bit-identical to the
    pre-registry behavior."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise KeyError(
            f"unknown placement policy {name!r} (known: {policy_names()})"
        )
    return factory()


def resolve(policy: "str | PlacementPolicy") -> PlacementPolicy:
    """The seam the scoring call sites use: pass-through for an already-
    constructed policy, registry lookup for a name."""
    if isinstance(policy, PlacementPolicy):
        return policy
    return get_policy(policy)


register_policy("greedy-binpack", GreedyBinpackPolicy)
register_policy("multi-objective", MultiObjectivePolicy)
register_policy("learned", LearnedStubPolicy)
register_policy("prefix-affinity", PrefixAffinityPolicy)
for _legacy in ("best-fit", "first-fit", "spread"):
    register_policy(_legacy, lambda n=_legacy: _LegacyPolicy(n))
