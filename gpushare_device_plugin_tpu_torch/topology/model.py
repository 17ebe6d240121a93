"""Node chip-interconnect model: coordinate grids, sub-slice enumeration,
and multi-objective slice scoring for gang placement.

Counterpart of ``gpushare_device_plugin_tpu/topology/model.py``, copied
whole.

TPU pods expose their chips as a coordinate grid wired by ICI links
(v4/v5-style ``XxYxZ`` pod topologies: a 4-chip host is ``2x2x1``, an
8-chip host ``2x2x2``). Tensor-parallel collectives ride those links, so
*which* chips a multi-chip pod is granted decides whether its psums cross
one hop or crawl the mesh. A workload therefore claims a **shape**
(``"2x2x1"``), or a bare chip count (``"4"``) when any arrangement will
do, and the control plane picks the concrete sub-slice.

This module is the pure device-shape layer under that decision:

- :func:`parse_shape` / :func:`format_shape` — the ``"2x2x1"`` wire form
  used by the pod's gang-shape annotation and the node topology label;
- :class:`ChipTopology` — one node's grid: chip index <-> coordinates,
  ICI (Manhattan) distance, and enumeration of every axis-aligned
  sub-grid that realizes a requested shape (all axis orientations; for a
  bare count, all grid factorizations);
- :meth:`ChipTopology.best_slice` — score-ranked choice among the
  feasible candidates, jointly minimizing (in lexicographic order):

  1. **ICI hops** — the sum of pairwise chip distances inside the slice
     (a 2x2 square beats a 4x1 line: tighter collectives);
  2. **stranded slivers** — total HBM units left free on the member
     chips after the claim (best-fit: don't leave unusable crumbs);
  3. **broken whole chips** — how many previously-untouched chips the
     slice cracks open (fragmentation: prefer re-using partially-used
     chips so whole chips stay available for exclusive/core pods);
  4. lowest chip index — determinism.

  This is the multi-objective MIG-style placement trade (PAPERS.md,
  arXiv 2502.01909 — fragmentation, spread, and topology scored
  jointly) restricted to one node's grid; the extender applies it per
  node, the allocator re-applies it at admission under the reservation
  overlay.

Everything here is pure data + math: no apiserver, no ledger, no JAX.
The gang *claim* protocol lives in ``allocator/`` and ``extender/``;
the granted slice's mesh materialization lives in ``parallel/podenv.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Mapping, Sequence

MAX_DIMS = 3


def parse_shape(raw: str) -> tuple[int, ...]:
    """``"2x2x1"`` -> ``(2, 2, 1)``; a bare count ``"4"`` -> ``(4,)``.

    Raises ``ValueError`` on anything else (empty, zero/negative dims,
    more than three axes) — callers surface that as a filter/admission
    failure, never a crash.
    """
    parts = [p.strip() for p in str(raw).lower().split("x")]
    if not parts or len(parts) > MAX_DIMS:
        raise ValueError(f"invalid gang shape {raw!r}: expected up to 3 'x'-separated dims")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"invalid gang shape {raw!r}: non-integer dim") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"invalid gang shape {raw!r}: dims must be >= 1")
    return dims


def format_shape(dims: Sequence[int]) -> str:
    return "x".join(str(d) for d in dims)


def shape_size(raw: str) -> int:
    """Chip count a shape string claims (``"2x2x1"`` -> 4, ``"4"`` -> 4)."""
    n = 1
    for d in parse_shape(raw):
        n *= d
    return n


def pad3(dims: Sequence[int]) -> tuple[int, int, int]:
    """Pad a 1-3 dim shape to the canonical (x, y, z) form — THE padding
    rule; the allocator's annotations and env payloads reuse it so the
    persisted shape and the injected carve-out can never diverge."""
    d = tuple(dims) + (1,) * (MAX_DIMS - len(dims))
    return d[0], d[1], d[2]


_pad3 = pad3


@dataclasses.dataclass(frozen=True)
class SliceCandidate:
    """One concrete sub-slice: the member chip indices (sorted), the
    realized shape, and its internal ICI cost (sum of pairwise Manhattan
    distances — the collective-traffic proxy the scorer minimizes)."""

    chips: tuple[int, ...]
    shape: tuple[int, int, int]
    hops: int


@dataclasses.dataclass(frozen=True)
class SliceScore:
    """The winning slice's multi-objective score components, in the
    lexicographic order :meth:`ChipTopology.best_slice` minimizes them:
    ICI hops, stranded slivers, broken whole chips, lowest-chip
    tie-break. Surfaced (rather than computed and discarded) so the
    decision-provenance layer can record *by what margin* a slice won —
    the policy-introspection seam pluggable placement policies
    implement."""

    hops: int
    stranded: int
    broken: int
    tie_break: int

    def to_dict(self) -> dict[str, int]:
        return {
            "ici_hops": self.hops,
            "stranded": self.stranded,
            "broken": self.broken,
            "tie_break": self.tie_break,
        }


class ChipTopology:
    """One node's chip grid. Chip index is row-major with x fastest:
    ``index = x + X*(y + Y*z)`` — matching the order discovery enumerates
    local devices, so index ``i`` here is local chip ``i`` everywhere
    else in the plugin."""

    def __init__(self, dims: Sequence[int]):
        x, y, z = _pad3(dims)
        if x < 1 or y < 1 or z < 1:
            raise ValueError(f"invalid topology dims {dims!r}")
        self.dims: tuple[int, int, int] = (x, y, z)

    def __repr__(self) -> str:
        return f"ChipTopology({format_shape(self.dims)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ChipTopology) and self.dims == other.dims

    @property
    def n_chips(self) -> int:
        x, y, z = self.dims
        return x * y * z

    @classmethod
    def default_for(cls, n_chips: int) -> "ChipTopology":
        """The standard grid for a chip count: near-cubic powers of two
        (4 -> 2x2x1, 8 -> 2x2x2, 16 -> 4x2x2 — the v4/v5 host and slice
        shapes); anything else degrades to a line (``Nx1x1``)."""
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        dims = [1, 1, 1]
        rem, axis = n_chips, 0
        while rem % 2 == 0:
            dims[axis % MAX_DIMS] *= 2
            rem //= 2
            axis += 1
        dims[0] *= rem  # odd remainder stretches x
        return cls(sorted(dims, reverse=True))

    @classmethod
    def from_label(cls, label: str | None, n_chips: int) -> "ChipTopology":
        """Topology from the node's ``tpushare.aliyun.com/topology`` label
        when present and consistent with the advertised chip count; the
        default grid otherwise (a garbled label must degrade to sane
        placement, not wedge scheduling)."""
        if label:
            try:
                topo = cls(_pad3(parse_shape(label)))
                if topo.n_chips == n_chips:
                    return topo
            except ValueError:
                pass
        return cls.default_for(n_chips)

    @classmethod
    def from_node(cls, node: Mapping, n_chips: int) -> "ChipTopology":
        """THE label rule, in one place: read the topology label off a
        node's JSON and apply :meth:`from_label`. The extender, the
        daemon's allocator, and the inspect CLI all derive a node's grid
        through this one classmethod so they can never disagree about
        the same node's wiring."""
        from .. import const

        label = (node.get("metadata", {}).get("labels") or {}).get(
            const.LABEL_NODE_TOPOLOGY
        )
        return cls.from_label(label, n_chips)

    # --- coordinates ------------------------------------------------------

    def coords(self, index: int) -> tuple[int, int, int]:
        x_dim, y_dim, _ = self.dims
        if not 0 <= index < self.n_chips:
            raise ValueError(f"chip index {index} out of range for {self!r}")
        x = index % x_dim
        y = (index // x_dim) % y_dim
        z = index // (x_dim * y_dim)
        return x, y, z

    def index(self, x: int, y: int, z: int) -> int:
        x_dim, y_dim, _ = self.dims
        return x + x_dim * (y + y_dim * z)

    def distance(self, a: int, b: int) -> int:
        """ICI hop distance (Manhattan on the grid; single-host grids
        don't wrap — the torus closes only at full-pod dimensions)."""
        ca, cb = self.coords(a), self.coords(b)
        return sum(abs(i - j) for i, j in zip(ca, cb))

    def slice_hops(self, chips: Iterable[int]) -> int:
        members = list(chips)
        return sum(
            self.distance(a, b) for a, b in itertools.combinations(members, 2)
        )

    # --- sub-slice enumeration -------------------------------------------

    def _orientations(self, shape_raw: str) -> list[tuple[int, int, int]]:
        """Distinct 3-d orientations that realize ``shape_raw``: axis
        permutations of an explicit shape, every grid factorization of a
        bare count."""
        dims = parse_shape(shape_raw)
        if len(dims) == 1:
            n = dims[0]
            out = {
                (dx, dy, dz)
                for dx in range(1, n + 1)
                if n % dx == 0
                for dy in range(1, n // dx + 1)
                if (n // dx) % dy == 0
                for dz in [n // dx // dy]
            }
        else:
            out = set(itertools.permutations(_pad3(dims)))
        return sorted(out)

    def candidates(self, shape_raw: str) -> list[SliceCandidate]:
        """Every axis-aligned sub-grid realizing ``shape_raw``, deduped by
        chip set. Counts are small (a host grid has <= 16 chips), so the
        enumeration is exhaustive rather than clever."""
        seen: dict[tuple[int, ...], SliceCandidate] = {}
        X, Y, Z = self.dims
        for dx, dy, dz in self._orientations(shape_raw):
            if dx > X or dy > Y or dz > Z:
                continue
            for ox in range(X - dx + 1):
                for oy in range(Y - dy + 1):
                    for oz in range(Z - dz + 1):
                        chips = tuple(
                            sorted(
                                self.index(ox + i, oy + j, oz + k)
                                for i in range(dx)
                                for j in range(dy)
                                for k in range(dz)
                            )
                        )
                        if chips not in seen:
                            seen[chips] = SliceCandidate(
                                chips=chips,
                                shape=(dx, dy, dz),
                                hops=self.slice_hops(chips),
                            )
        return sorted(seen.values(), key=lambda c: (c.hops, c.chips))

    # --- scoring ----------------------------------------------------------

    def best_slice(
        self,
        shape_raw: str,
        free: Mapping[int, int],
        per_chip: int,
        *,
        capacity: Mapping[int, int] | None = None,
        excluded: Iterable[int] = (),
    ) -> SliceCandidate | None:
        """The best feasible sub-slice for ``shape_raw`` at ``per_chip``
        units per member chip, or None when nothing fits (the score-less
        convenience form of :meth:`best_slice_scored`).

        Feasible: every member chip has >= ``per_chip`` free units and is
        not in ``excluded`` (unhealthy / core-held chips). ``capacity``
        (chip -> total units) feeds the broken-whole-chip objective; when
        omitted, a chip whose free equals the max observed free is treated
        as whole.
        """
        scored = self.best_slice_scored(
            shape_raw, free, per_chip, capacity=capacity, excluded=excluded
        )
        return None if scored is None else scored[0]

    def best_slice_scored(
        self,
        shape_raw: str,
        free: Mapping[int, int],
        per_chip: int,
        *,
        capacity: Mapping[int, int] | None = None,
        excluded: Iterable[int] = (),
    ) -> tuple[SliceCandidate, SliceScore] | None:
        """:meth:`best_slice` plus the winner's :class:`SliceScore` —
        the objective components the ranking minimized, surfaced for
        decision provenance instead of discarded."""
        if per_chip < 0:
            raise ValueError(f"per_chip must be >= 0, got {per_chip}")
        banned = set(excluded)
        cap = dict(capacity) if capacity is not None else {}
        best: tuple | None = None
        best_cand: SliceCandidate | None = None
        for cand in self.candidates(shape_raw):
            if any(i in banned or free.get(i, 0) < per_chip for i in cand.chips):
                continue
            stranded = sum(free.get(i, 0) - per_chip for i in cand.chips)
            broken = sum(
                1
                for i in cand.chips
                if free.get(i, 0) == cap.get(i, free.get(i, 0))
                and free.get(i, 0) - per_chip > 0
            )
            key = (cand.hops, stranded, broken, cand.chips[0])
            if best is None or key < best:
                best, best_cand = key, cand
        if best_cand is None or best is None:
            return None
        return best_cand, SliceScore(
            hops=best[0], stranded=best[1], broken=best[2], tie_break=best[3]
        )
