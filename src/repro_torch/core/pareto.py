"""Pareto-front machinery over d-dimensional objective vectors.

Pure functions; used by the partitioner, the benchmarks, and the
scheduler.  An :class:`Objective` names one axis (``latency``,
``throughput``, ``energy``, …) with a per-axis sense (``min``/``max``)
and knows how to read its value off a point.  Points are either

  * objects exposing the objective's attribute (``PipelineMetrics``
    qualifies: ``latency_s``, ``throughput``, ``energy_j``), or
  * plain tuples/lists, read positionally in the order of the active
    objective set — so the legacy ``(lat, thr)`` tuples keep working
    under the default ``(LATENCY, THROUGHPUT)`` pair, and d=3 tests can
    pass ``(lat, thr, energy)``.

Every public function takes ``objectives=None`` meaning the legacy
bi-objective (latency ↓, throughput ↑) pair, so all existing callers
run unchanged; pass ``("latency", "throughput", "energy")`` (names or
``Objective`` instances) for the 3-D front.

Complexity: ``pareto_front`` is the O(n log n) sort-sweep for d=2, a
lexicographic sweep with a staircase (the classic divide-and-conquer
maxima structure flattened into one bisect-maintained envelope) for
d=3, and pairwise O(d·n²) beyond.  ``hypervolume`` is the exact sweep
for d=2 and recursive slicing (HSO) for d≥3.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence, TypeVar, Union

T = TypeVar("T")


# --------------------------------------------------------------------------- #
# Objective protocol
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Objective:
    """One axis of the objective vector.

    ``attr`` is the attribute read off metric objects; plain tuples are
    read positionally (position in the active objective set).  ``getter``
    overrides attribute access for custom point types.
    """

    name: str
    sense: str                          # "min" | "max"
    attr: str
    getter: Callable | None = None

    def __post_init__(self):
        if self.sense not in ("min", "max"):
            raise ValueError(f"objective {self.name!r}: sense must be "
                             f"'min' or 'max', got {self.sense!r}")

    def value(self, p, position: int | None = None) -> float:
        if isinstance(p, (tuple, list)):
            if position is None:
                raise ValueError("positional read needs the objective's "
                                 "position in the active set")
            return float(p[position])
        if self.getter is not None:
            return float(self.getter(p))
        return float(getattr(p, self.attr))


LATENCY = Objective("latency", "min", "latency_s")
THROUGHPUT = Objective("throughput", "max", "throughput")
ENERGY = Objective("energy", "min", "energy_j")
# the codec axis: predicted end-task fidelity under the partition's
# per-hop wire codecs (product of per-cut top-1 agreements; 1.0 when
# every hop ships uncoded)
ACCURACY = Objective("accuracy", "max", "accuracy")

OBJECTIVES: dict[str, Objective] = {
    o.name: o for o in (LATENCY, THROUGHPUT, ENERGY, ACCURACY)}

#: The paper's original bi-objective pair — the default everywhere.
DEFAULT_OBJECTIVES: tuple[Objective, ...] = (LATENCY, THROUGHPUT)

#: Widening order: ``objectives=d`` (an int) takes the first d axes.
CANONICAL_ORDER: tuple[Objective, ...] = (LATENCY, THROUGHPUT, ENERGY,
                                          ACCURACY)

ObjectiveLike = Union[str, Objective]


def resolve_objectives(
    objectives: Sequence[ObjectiveLike] | int | None = None,
) -> tuple[Objective, ...]:
    """Normalize names/instances to a tuple of Objectives (None = legacy
    (latency, throughput) pair).  An int d selects the first d axes of
    the canonical (latency, throughput, energy, accuracy) order — so
    ``objectives=4`` is the full codec-aware front."""
    if objectives is None:
        return DEFAULT_OBJECTIVES
    if isinstance(objectives, int):
        if not 1 <= objectives <= len(CANONICAL_ORDER):
            raise ValueError(f"objectives={objectives}: int form selects "
                             f"1..{len(CANONICAL_ORDER)} canonical axes")
        return CANONICAL_ORDER[:objectives]
    out: list[Objective] = []
    for o in objectives:
        if isinstance(o, Objective):
            out.append(o)
        elif o in OBJECTIVES:
            out.append(OBJECTIVES[o])
        else:
            raise ValueError(f"unknown objective {o!r}; "
                             f"have {sorted(OBJECTIVES)}")
    if not out:
        raise ValueError("need at least one objective")
    return tuple(out)


def vector(p, objectives: Sequence[ObjectiveLike] | None = None
           ) -> tuple[float, ...]:
    """The point's raw objective vector, in objective order."""
    objs = resolve_objectives(objectives)
    return tuple(o.value(p, i) for i, o in enumerate(objs))


def _key(p, objs: tuple[Objective, ...]) -> tuple[float, ...]:
    """Minimization-convention vector (max axes negated): componentwise
    ``<=`` on keys means 'no worse' on every objective."""
    return tuple(o.value(p, i) if o.sense == "min" else -o.value(p, i)
                 for i, o in enumerate(objs))


def _dominates_key(ka: tuple[float, ...], kb: tuple[float, ...]) -> bool:
    return all(a <= b for a, b in zip(ka, kb)) and \
        any(a < b for a, b in zip(ka, kb))


# --------------------------------------------------------------------------- #
# Dominance and fronts
# --------------------------------------------------------------------------- #
def dominates(a, b, objectives: Sequence[ObjectiveLike] | None = None) -> bool:
    """a dominates b: no worse on every objective, strictly better on one."""
    objs = resolve_objectives(objectives)
    return _dominates_key(_key(a, objs), _key(b, objs))


def pareto_front(points: Sequence[T],
                 objectives: Sequence[ObjectiveLike] | None = None) -> list[T]:
    """Non-dominated subset, sorted by the first objective (best first).

    Duplicate objective vectors keep one representative.  d=2 is the
    O(n log n) sort-sweep; d=3 a lexicographic sweep with a staircase
    envelope (also O(n log n)); higher d falls back to pairwise checks.
    """
    objs = resolve_objectives(objectives)
    if not points:
        return []
    return min_front([(_key(p, objs), p) for p in points])


def min_front(keyed: list[tuple[tuple[float, ...], T]]) -> list[T]:
    """Non-dominated payloads under componentwise-minimization vectors,
    sorted by vector; duplicate vectors keep one payload.  This is the
    kernel shared by ``pareto_front`` and the partitioner's DP label
    pruning (labels are already min-convention vectors there)."""
    if not keyed:
        return []
    keyed = sorted(keyed, key=lambda kp: kp[0])
    d = len(keyed[0][0])
    if d == 1:
        return [keyed[0][1]]
    if d == 2:
        front: list[T] = []
        best1 = float("inf")
        for k, p in keyed:
            if k[1] < best1:
                front.append(p)
                best1 = k[1]
        return front
    if d == 3:
        return _front_3d(keyed)
    return _front_nd(keyed)


def _front_3d(keyed: list[tuple[tuple[float, ...], T]]) -> list[T]:
    """Lexicographic sweep: with points sorted by k0, a point is dominated
    iff some earlier point is ≤ on (k1, k2) — a 2-D staircase query."""
    front: list[T] = []
    stair1: list[float] = []          # k1, ascending
    stair2: list[float] = []          # matching k2, strictly descending
    prev_key: tuple[float, ...] | None = None
    for k, p in keyed:
        if k == prev_key:             # duplicate vector: keep first
            continue
        prev_key = k
        _, k1, k2 = k
        i = bisect.bisect_right(stair1, k1) - 1
        if i >= 0 and stair2[i] <= k2:
            continue                  # dominated (or duplicate cross-k0)
        front.append(p)
        # insert (k1, k2), dropping staircase entries it covers
        j = bisect.bisect_left(stair1, k1)
        hi = j
        while hi < len(stair1) and stair2[hi] >= k2:
            hi += 1
        stair1[j:hi] = [k1]
        stair2[j:hi] = [k2]
    return front


def _front_nd(keyed: list[tuple[tuple[float, ...], T]]) -> list[T]:
    front: list[T] = []
    front_keys: list[tuple[float, ...]] = []
    seen: set[tuple[float, ...]] = set()
    for k, p in keyed:
        if k in seen:
            continue
        seen.add(k)
        # sorted order: only already-accepted points can dominate k
        if any(_dominates_key(fk, k) for fk in front_keys):
            continue
        front.append(p)
        front_keys.append(k)
    return front


def is_on_front(p, points: Iterable,
                objectives: Sequence[ObjectiveLike] | None = None) -> bool:
    objs = resolve_objectives(objectives)
    kp = _key(p, objs)
    return not any(_dominates_key(_key(q, objs), kp) for q in points)


# --------------------------------------------------------------------------- #
# Hypervolume
# --------------------------------------------------------------------------- #
def hypervolume(points: Sequence,
                ref: float | Sequence[float] | None = None,
                objectives: Sequence[ObjectiveLike] | None = None,
                *, ref_latency: float | None = None,
                ref_throughput: float = 0.0) -> float:
    """Hypervolume dominated w.r.t. a reference point — higher is better.

    ``ref`` is the reference vector in objective order (worse than the
    interesting region on every axis: above on min axes, below on max
    axes).  The legacy 2-D-only signature
    ``hypervolume(points, ref_latency, ref_throughput=0.0)`` it replaces
    is still accepted: a scalar ``ref`` (or the ``ref_latency=`` keyword)
    means (latency ↓, throughput ↑) with the throughput reference
    defaulting to 0.

    Raises ``ValueError`` for an invalid reference box: one that no
    point lies strictly inside (e.g. every point's latency above the
    latency reference, or the throughput reference at/above every
    point's throughput — a reference that is not worse than the cloud
    on a max axis).  Individual points outside a valid box still
    contribute nothing.  Empty ``points`` returns 0.0.

    Exact: sort-sweep for d=2, recursive slicing (HSO) for d≥3.
    """
    if ref_latency is not None:
        if ref is not None:
            raise ValueError("pass either ref or ref_latency, not both")
        ref = (ref_latency, ref_throughput)
    elif isinstance(ref, (int, float)):
        # legacy positional forms: (points, ref_lat) and (points, ref_lat,
        # ref_thr) — in the latter the old third positional lands in
        # ``objectives``
        if isinstance(objectives, (int, float)):
            ref = (float(ref), float(objectives))
            objectives = None
        else:
            ref = (float(ref), ref_throughput)
    objs = resolve_objectives(objectives)
    if ref is None or len(ref) != len(objs):
        raise ValueError(f"need a {len(objs)}-dim reference vector")
    if not points:
        return 0.0
    kref = tuple(r if o.sense == "min" else -r for r, o in zip(ref, objs))
    inside = [k for k in (_key(p, objs) for p in points)
              if all(ki < ri for ki, ri in zip(k, kref))]
    if not inside:
        raise ValueError(
            f"invalid reference box {tuple(ref)!r}: no point lies strictly "
            "inside it (the reference must be worse than at least one "
            "point on every objective)")
    # reduce to the non-dominated subset before slicing
    front_keys = _front_nd(sorted((k, k) for k in inside))
    return _hv_min(front_keys, kref)


def _hv_min(keys: list[tuple[float, ...]], ref: tuple[float, ...]) -> float:
    """Exact hypervolume of minimization vectors strictly inside ref."""
    d = len(ref)
    if not keys:
        return 0.0
    if d == 1:
        return ref[0] - min(k[0] for k in keys)
    if d == 2:
        # non-dominated staircase (inputs may be raw projections from the
        # slicing recursion), then sum strips from worst to best k0
        stairs: list[tuple[float, ...]] = []
        best1 = float("inf")
        for k in sorted(set(keys)):
            if k[1] < best1:
                stairs.append(k)
                best1 = k[1]
        hv = 0.0
        prev0 = ref[0]
        for k0, k1 in reversed(stairs):
            hv += (prev0 - k0) * (ref[1] - k1)
            prev0 = k0
        return hv
    # slice on the last axis: between consecutive levels the cross-section
    # is the (d-1)-dim hypervolume of everything at or below the level
    order = sorted(keys, key=lambda k: k[-1])
    hv = 0.0
    for i, k in enumerate(order):
        z_lo = k[-1]
        z_hi = order[i + 1][-1] if i + 1 < len(order) else ref[-1]
        if z_hi > z_lo:
            hv += (z_hi - z_lo) * _hv_min([u[:-1] for u in order[:i + 1]],
                                          ref[:-1])
    return hv


# --------------------------------------------------------------------------- #
# Knee point
# --------------------------------------------------------------------------- #
def knee_point(points: Sequence[T],
               objectives: Sequence[ObjectiveLike] | None = None) -> T | None:
    """The front point with the max normalized Manhattan improvement —
    a pragmatic 'balanced' pick for practitioners (paper Sec. V-A asks
    which split balances the objectives); generalizes to any d by
    summing each axis's normalized goodness over the front's span."""
    objs = resolve_objectives(objectives)
    front = pareto_front(points, objs)
    if not front:
        return None
    cols = list(zip(*(_key(p, objs) for p in front)))
    los = [min(c) for c in cols]
    spans = [(max(c) - lo) or 1.0 for c, lo in zip(cols, los)]

    def score(p) -> float:
        k = _key(p, objs)
        return sum((lo + span - v) / span
                   for v, lo, span in zip(k, los, spans))

    return max(front, key=score)
