"""Query planning for the interactive service: canonical cache keys + LRU
result/bounds caches, keyed off the logical-plan IR.

Two cache tiers, matching how a GUI session actually refines queries:

* **result cache** — keyed by the *whole* plan (predicate tree, ranking
  expression, k, order, mask_types, ROI content).  A repeated query is
  answered with zero mask loads.
* **bounds cache** — keyed **per value expression** by everything that
  determines the candidate set and the CHI bounds pass (expression, mask
  types, grouping, ROI content) but *not* by comparison op / threshold / k
  or by the rest of the plan.  A refined query (same expressions, new
  thresholds, rearranged boolean structure, or a larger LIMIT) reuses every
  prior bounds pass for free and pays only for the changed verification
  residue — and two *different* plans sharing a CP expression share its
  bounds entry.

Keys are canonical strings built from the frozen-dataclass expression reprs
(deterministic) plus a content hash of any caller-provided ROI array.

Both tiers fold the store's **epoch** into every key: the moment the mask
database mutates (append/update/delete), every pre-epoch result and bounds
entry becomes unreachable — a refined query after an ingest pays a fresh
bounds pass instead of pruning against a dead index.  The service also
sweeps the dead generation out eagerly (:meth:`Planner.evict_dead_epochs`)
so stale entries never squat in the LRU displacing live ones.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

from .. import lockcheck
from ..core.exprs import Node
from ..core.plan import LogicalPlan


def _as_plan(plan_or_query) -> LogicalPlan:
    if isinstance(plan_or_query, LogicalPlan):
        return plan_or_query
    return plan_or_query.plan          # queries.Query compat


def expr_signature(node: Optional[Node]) -> str:
    """Deterministic canonical form of an expression tree (frozen dataclass
    reprs are stable and include every field)."""
    return repr(node)


def roi_signature(rois: Optional[np.ndarray]) -> str:
    """Content hash of a provided-ROI array (the per-mask boxes a session
    queries against); two sessions sharing boxes share cache entries."""
    if rois is None:
        return "none"
    arr = np.ascontiguousarray(np.asarray(rois))
    return hashlib.sha1(arr.tobytes() + str(arr.shape).encode()).hexdigest()[:16]


def _backend_tag(backend: str, packed: bool) -> str:
    """Fold the store's mask representation into the backend key component
    (NOT a trailing component — ``evict_dead_epochs`` parses the epoch off
    the end).  A store re-ingested packed at the same epoch counter must
    never serve float-era cache entries, and vice versa."""
    return f"{backend}+packed" if packed else backend


def result_key(plan_or_query, roi_sig: str, backend: str = "host",
               epoch: int = 0, packed: bool = False) -> str:
    return "|".join([_as_plan(plan_or_query).signature(), roi_sig,
                     _backend_tag(backend, packed), f"e{int(epoch)}"])


def bounds_key(expr: Node, plan_or_query, roi_sig: str,
               backend: str = "host", epoch: int = 0,
               packed: bool = False, *, tier: int = 0) -> str:
    """One *value expression*'s bounds-cache key: everything that pins the
    candidate set + its CHI pass — NOT op/threshold/k or the rest of the
    plan, so refined and restructured queries hit the same entries.
    Keys carry the execution backend's name: bounds are numerically
    identical across backends, but entries stay attributable (and a
    service switching backends never serves stale placement decisions).
    They also carry the CHI pyramid **tier** the bounds were computed at
    (DESIGN.md §13) — a coarse-tier interval soundly *contains* the fine
    one, so serving it for a refined request would silently widen bounds;
    the tier component makes that impossible — and the store epoch, so a
    mutation makes every pre-epoch bounds pass unreachable, plus the
    packed-representation tag, so a float-era entry never answers for a
    packed store (or vice versa).  The epoch stays the trailing component
    (``evict_dead_epochs`` parses it off the end)."""
    plan = _as_plan(plan_or_query)
    return "|".join([
        expr_signature(expr),
        str(None if plan.mask_types is None
            else tuple(sorted(plan.mask_types))),
        str(plan.grouped), roi_sig, _backend_tag(backend, packed),
        f"t{int(tier)}", f"e{int(epoch)}",
    ])


@dataclasses.dataclass
class CacheInfo:
    hits: int = 0
    misses: int = 0
    evictions: int = 0           # displaced by the capacity bound
    invalidations: int = 0       # dropped because their epoch died
    size: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class LRUCache:
    """Tiny ordered-dict LRU with hit/miss/eviction accounting.

    Thread-safe: the service runs under ``ThreadingHTTPServer``, and a bare
    ``OrderedDict`` corrupts under concurrent ``get``/``put`` (move_to_end
    during iteration of a resize) — every operation holds a lock."""

    def __init__(self, capacity: int, name: str = "cache"):
        self.capacity = max(int(capacity), 0)
        self._data: OrderedDict = OrderedDict()
        self._lock = lockcheck.make_lock(f"planner.{name}")
        self.info = CacheInfo()

    def get(self, key):
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.info.hits += 1
                return self._data[key]
            self.info.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            if self.capacity == 0:
                return
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.info.evictions += 1
            self.info.size = len(self._data)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def evict_where(self, pred) -> int:
        """Drop every entry whose key satisfies ``pred`` (accounted as
        invalidations, not capacity evictions).  Returns the count."""
        with self._lock:
            dead = [k for k in self._data if pred(k)]
            for k in dead:
                del self._data[k]
            self.info.invalidations += len(dead)
            self.info.size = len(self._data)
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.info.size = 0


class _PlanBoundsHook:
    """Adapts the planner's LRU to the engine's per-run bounds hook
    (``get(expr, tier)`` / ``put(expr, lb, ub, tier)``), closing over the
    plan context that pins the candidate set; the engine passes the tier
    the pass ran at (the finest grid on the classic path)."""

    def __init__(self, cache: LRUCache, plan: LogicalPlan, roi_sig: str,
                 backend: str = "host", epoch: int = 0,
                 packed: bool = False):
        self._cache = cache
        self._plan = plan
        self._roi_sig = roi_sig
        self._backend = backend
        self._epoch = epoch
        self._packed = packed

    def get(self, expr: Node, tier: int = 0):
        return self._cache.get(
            bounds_key(expr, self._plan, self._roi_sig, self._backend,
                       self._epoch, self._packed, tier=tier))

    def put(self, expr: Node, lb: np.ndarray, ub: np.ndarray,
            tier: int = 0) -> None:
        self._cache.put(
            bounds_key(expr, self._plan, self._roi_sig, self._backend,
                       self._epoch, self._packed, tier=tier),
            (lb, ub))


class Planner:
    """Canonicalizes plans into cache keys and owns the two caches."""

    def __init__(self, *, result_cache_size: int = 128,
                 bounds_cache_size: int = 64):
        self.result_cache = LRUCache(result_cache_size, name="results")
        self.bounds_cache = LRUCache(bounds_cache_size, name="bounds")

    # -- result tier ------------------------------------------------------
    def cached_result(self, plan_or_query, roi_sig: str,
                      backend: str = "host", epoch: int = 0,
                      packed: bool = False):
        return self.result_cache.get(
            result_key(plan_or_query, roi_sig, backend, epoch, packed))

    def store_result(self, plan_or_query, roi_sig: str, payload,
                     backend: str = "host", epoch: int = 0,
                     packed: bool = False) -> None:
        self.result_cache.put(
            result_key(plan_or_query, roi_sig, backend, epoch, packed),
            payload)

    # -- bounds tier ------------------------------------------------------
    def bounds_hook(self, plan_or_query, roi_sig: str,
                    backend: str = "host", epoch: int = 0,
                    packed: bool = False) -> _PlanBoundsHook:
        """The per-expression bounds cache, scoped to one plan's candidate
        set at one store epoch — hand this to
        :func:`repro_torch.core.plan.compile_plan`."""
        return _PlanBoundsHook(self.bounds_cache, _as_plan(plan_or_query),
                               roi_sig, backend, epoch, packed)

    def evict_dead_epochs(self, epoch: int) -> int:
        """Drop every result/bounds entry keyed to an epoch other than
        ``epoch``.  Both key builders end with an ``e<epoch>`` component,
        so a mutation makes pre-epoch entries *unreachable* — but without
        this sweep they would still squat in the LRU, displacing live
        entries until enough new traffic ages them out.  Called by the
        service on every ingest/delete; returns the number dropped."""
        tag = f"e{int(epoch)}"

        def dead(key: str) -> bool:
            return key.rsplit("|", 1)[-1] != tag

        return (self.result_cache.evict_where(dead) +
                self.bounds_cache.evict_where(dead))

    def stats(self) -> dict:
        return {"result_cache": self.result_cache.info.as_dict(),
                "bounds_cache": self.bounds_cache.info.as_dict()}

    def register_metrics(self, registry) -> None:
        """Expose both cache tiers on a :class:`~repro_torch.obs.metrics.
        MetricsRegistry` — pull-based, so every scrape reflects the live
        :class:`CacheInfo` without touching the query path."""
        from ..obs.metrics import dataclass_sampler
        registry.register_collector(dataclass_sampler(
            "masksearch_result_cache", "gauge",
            "Planner result-cache (whole-plan LRU) state",
            lambda: self.result_cache.info))
        registry.register_collector(dataclass_sampler(
            "masksearch_bounds_cache", "gauge",
            "Planner bounds-cache (per-expression LRU) state",
            lambda: self.bounds_cache.info))
