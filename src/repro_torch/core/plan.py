"""The composable query-plan IR: logical plans + one physical Run API.

A :class:`LogicalPlan` is the canonical description of any front-end query —
source (mask-type restriction, optional grouping) → boolean predicate tree
(:mod:`.exprs` ``Pred``) → ranking or scalar aggregation.  The SQL parser
(:mod:`.queries`) compiles text to this IR; programmatic callers build it
directly; the service canonicalizes it into cache keys.

:func:`compile_plan` lowers a logical plan to exactly one physical run
object from :mod:`.engine` — :class:`~.engine.FilterRun`,
:class:`~.engine.TopKRun`, :class:`~.engine.FilteredTopKRun`,
:class:`~.engine.ScalarAggRun`, :class:`~.engine.MinMaxAggRun`, or their
dual-mask (pair) siblings :class:`~.engine.PairFilterRun` /
:class:`~.engine.PairTopKRun` / :class:`~.engine.PairFilteredTopKRun`
when the expressions contain pair terms (DESIGN.md §9) — all of
which present the uniform ``target / take_batch / apply_exact / finished /
result`` interface, so sessions, the fused scheduler, and any future
operator (pagination over filters, joins, distributed sharding) drive them
identically.

:func:`run_plan` is the one-shot driver, including the ``use_index=False``
full-scan baseline every plan kind can be checked against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..obs import trace as _trace
from . import engine
from .exprs import (And, BinOp, Cmp, CP, Node, Not, Or, PairTerm, Pred,
                    RoiArea, TypeIn, is_group_expr, is_pair_expr,
                    pair_roles_of)

_KINDS = ("filter", "topk", "filtered_topk", "scalar_agg")


@dataclasses.dataclass(frozen=True)
class LogicalPlan:
    """source → predicate → rank/aggregate, as one immutable record.

    Exactly one of the three output shapes is active:

    * ``order_by`` set → a ranking (``topk``; ``filtered_topk`` when a
      predicate is also present);
    * ``agg`` set → a scalar aggregation over ``agg_expr``;
    * neither → a filter (``predicate`` required).
    """

    select: str = "mask_id"               # "mask_id" | "image_id"
    predicate: Optional[Pred] = None      # boolean predicate tree
    mask_types: Optional[tuple] = None    # source-level type restriction
    order_by: Optional[Node] = None       # ranking expression
    k: Optional[int] = None
    desc: bool = True
    agg: Optional[str] = None             # SUM | AVG | MIN | MAX
    agg_expr: Optional[Node] = None
    group_by_image: bool = False

    def __post_init__(self):
        # Normalize so semantically identical plans share one signature()
        # (and thus one service cache entry): aggregate names are
        # case-insensitive, and ranking fields are dead without ORDER BY.
        if self.agg is not None:
            object.__setattr__(self, "agg", self.agg.upper())
        if self.order_by is None:
            object.__setattr__(self, "k", None)
            object.__setattr__(self, "desc", True)
        # Pair (dual-mask) plans evaluate per image and return image ids;
        # normalize the default select so programmatic plans behave like
        # parsed ones.
        if self.select == "mask_id" and self.paired:
            object.__setattr__(self, "select", "image_id")

    @property
    def kind(self) -> str:
        if self.agg is not None:
            return "scalar_agg"
        if self.order_by is not None:
            return "filtered_topk" if self.predicate is not None else "topk"
        return "filter"

    def exprs(self) -> list:
        """Every distinct value expression the plan evaluates."""
        out: list = []
        if self.predicate is not None:
            out.extend(self.predicate.value_exprs())
        for e in (self.order_by, self.agg_expr):
            if e is not None and e not in out:
                out.append(e)
        return out

    @property
    def paired(self) -> bool:
        """Whether this is a dual-mask (pair) plan: any expression contains
        a :class:`~repro_torch.core.exprs.PairTerm`.  Pair plans evaluate per
        image over (role_a, role_b) mask pairs."""
        return any(is_pair_expr(e) for e in self.exprs())

    @property
    def grouped(self) -> bool:
        """Whether execution evaluates per image group rather than per mask.
        ``select="image_id"`` implies grouping (as in the SQL front-end),
        so programmatically built plans behave like parsed ones.  Pair
        plans are their own unit (per-image *role pairs*, not groups)."""
        if self.paired:
            return False
        return (self.group_by_image or self.select == "image_id" or
                any(is_group_expr(e) for e in self.exprs()))

    def validate(self) -> "LogicalPlan":
        kind = self.kind
        if kind == "filter" and self.predicate is None:
            raise ValueError("filter plan needs a predicate")
        if kind in ("topk", "filtered_topk"):
            if self.k is None:
                raise ValueError("ranking plan needs k (LIMIT)")
            if self.k < 1:
                raise ValueError(f"LIMIT must be a positive integer, "
                                 f"got {self.k}")
        if self.paired:
            pair_roles_of(self.exprs())   # raises on mixed role pairings
            mixed = [t for e in self.exprs() for t in e.cp_terms()
                     if not isinstance(t, PairTerm)]
            if mixed:
                # AREA(roi) stays legal (normalized discrepancies); any
                # other counted term is a unit mismatch.
                raise ValueError(
                    "a dual-mask (pair) plan cannot mix in per-mask CP or "
                    "MASK_AGG terms; every count must be a pair stat "
                    f"(offending: {mixed[0]!r})")
            if self.mask_types is not None or (
                    self.predicate is not None and
                    _has_type_leaf(self.predicate)):
                raise ValueError(
                    "pair plans select their masks by role (the two "
                    "mask_types named in the pair terms); drop the "
                    "mask_type IN (...) restriction")
            if self.select != "image_id":
                raise ValueError("pair plans evaluate per image; "
                                 "SELECT image_id")
        if any(is_group_expr(e) for e in self.exprs()):
            bad = [e for e in self.exprs() if _has_per_mask_leaf(e)]
            if bad:
                raise ValueError(
                    "a MASK_AGG (grouped) plan cannot mix in per-mask "
                    "CP/AREA terms; use CP(intersect|union(mask > t), ...) "
                    f"expressions throughout (offending: {bad[0]!r})")
        if kind == "scalar_agg":
            if self.agg_expr is None:
                raise ValueError("scalar_agg plan needs agg_expr")
            if self.agg.upper() not in ("SUM", "AVG", "MIN", "MAX"):
                raise ValueError(f"unknown aggregate {self.agg!r}")
        if self.select not in ("mask_id", "image_id"):
            raise ValueError(f"can only SELECT mask_id/image_id, "
                             f"got {self.select!r}")
        if self.grouped and self.predicate is not None and \
                _has_type_leaf(self.predicate):
            raise ValueError("mask_type IN below AND/OR/NOT cannot appear in "
                             "a grouped (MASK_AGG / GROUP BY) plan; use it as "
                             "a top-level conjunct instead")
        return self

    def signature(self) -> str:
        """Deterministic canonical form (frozen-dataclass reprs are stable
        and include every field) — the service's cache-key input."""
        return "|".join([
            self.kind, self.select, repr(self.predicate), repr(self.order_by),
            str(self.k), str(self.desc), str(self.agg), repr(self.agg_expr),
            str(None if self.mask_types is None
                else tuple(sorted(self.mask_types))),
            str(self.grouped),
        ])


def _has_per_mask_leaf(node: Node) -> bool:
    """True if the expression contains a leaf only evaluable per mask
    (a plain CP or an AREA term) — invalid inside a grouped plan."""
    if isinstance(node, (CP, RoiArea)):
        return True
    if isinstance(node, BinOp):
        return _has_per_mask_leaf(node.left) or _has_per_mask_leaf(node.right)
    return False


def _has_type_leaf(pred: Pred) -> bool:
    if isinstance(pred, TypeIn):
        return True
    if isinstance(pred, (And, Or)):
        return _has_type_leaf(pred.left) or _has_type_leaf(pred.right)
    if isinstance(pred, Not):
        return _has_type_leaf(pred.child)
    return False


def simplify_predicate(pred: Optional[Pred]):
    """Split source-level ``mask_type IN`` conjuncts out of a predicate tree.

    Returns ``(mask_types, residue)``: every :class:`TypeIn` reachable
    through top-level ``And`` nodes becomes a candidate-set restriction
    (intersected if repeated) — pruning the source *before* the bounds pass,
    exactly like the flat front-end did — and the remaining conjuncts are
    reassembled (left-associated, original order) as the residue predicate.
    ``TypeIn`` below ``Or``/``Not`` stays in the tree and is decided as an
    ordinary (never-unknown) leaf.
    """
    if pred is None:
        return None, None
    conjuncts: list = []

    def _flatten(p: Pred) -> None:
        if isinstance(p, And):
            _flatten(p.left)
            _flatten(p.right)
        else:
            conjuncts.append(p)

    _flatten(pred)
    mask_types: Optional[tuple] = None
    rest: list = []
    for c in conjuncts:
        if isinstance(c, TypeIn):
            if mask_types is None:
                mask_types = tuple(c.types)
            else:
                mask_types = tuple(t for t in mask_types if t in c.types)
        else:
            rest.append(c)
    residue: Optional[Pred] = None
    for c in rest:
        residue = c if residue is None else And(residue, c)
    return mask_types, residue


# ---------------------------------------------------------------------------
# Physical compilation
# ---------------------------------------------------------------------------


def compile_plan(store, plan: LogicalPlan, *, provided_rois=None,
                 verify_batch: int = 256, bounds_hook=None, positions=None,
                 bounds=None, backend=None):
    """Lower a logical plan to its resumable physical run.

    ``bounds_hook`` (``get(expr)``/``put(expr, lb, ub)``) lets the caller —
    the service planner — cache per-expression CHI bounds across runs.
    ``positions`` restricts the candidate set to explicit store rows;
    ``bounds`` is the legacy precomputed ``(lb, ub)`` pair for a
    single-expression filter/top-k plan.  ``backend`` selects the physical
    execution layer (``"host"``, ``"device"``, ``None`` for the store's
    own device — the device backend on a CUDA store, else the host — or an
    :class:`repro_torch.core.backend.ExecBackend` instance); every backend
    returns identical results.
    """
    plan.validate()
    common = dict(mask_types=plan.mask_types,
                  group_by_image=plan.grouped,
                  provided_rois=provided_rois, verify_batch=verify_batch,
                  bounds_hook=bounds_hook, positions=positions,
                  backend=backend)
    kind = plan.kind
    if bounds is not None and not (
            kind == "topk" or
            (kind == "filter" and isinstance(plan.predicate, Cmp))):
        raise ValueError(
            "bounds= applies only to single-expression filter/top-k plans; "
            "use bounds_hook to cache per-expression bounds for "
            f"{kind!r} plans")
    paired = plan.paired
    # Run construction is the plan/compile phase: context build + the full
    # CHI bounds pass (per-expression ``bounds`` spans nest inside).
    with _trace.span("plan.compile") as sp:
        run = _lower(store, plan, kind, paired, bounds, common)
        sp.set(kind=kind, candidates=run.n)
    return run


def _lower(store, plan, kind, paired, bounds, common):
    if kind == "filter":
        cls = engine.PairFilterRun if paired else engine.FilterRun
        return cls(store, plan.predicate, bounds=bounds, **common)
    if kind == "topk":
        cls = engine.PairTopKRun if paired else engine.TopKRun
        return cls(store, plan.order_by, desc=plan.desc, bounds=bounds,
                   **common)
    if kind == "filtered_topk":
        cls = engine.PairFilteredTopKRun if paired else engine.FilteredTopKRun
        return cls(store, plan.predicate, plan.order_by, desc=plan.desc,
                   **common)
    agg = plan.agg.upper()
    if agg in ("MIN", "MAX"):
        return engine.MinMaxAggRun(store, plan.agg_expr, agg, **common)
    return engine.ScalarAggRun(store, plan.agg_expr, agg, **common)


def run_plan(store, plan: LogicalPlan, *, provided_rois=None,
             use_index: bool = True, verify_batch: Optional[int] = None,
             bounds_hook=None, positions=None, bounds=None, backend=None):
    """One-shot execution of a logical plan → ``(payload, stats)``.

    Payload shapes match the legacy front-end exactly: ``filter`` → ids,
    ``topk``/``filtered_topk`` → ``(ids, scores)``, ``scalar_agg`` → float.
    ``use_index=False`` is the full-scan baseline for every plan kind (it
    always runs on the host — it exists to check the backends against).

    ``verify_batch`` defaults per kind: rankings (and MIN/MAX, which share
    their early-termination loop) verify in 256-candidate rounds; filters
    and SUM/AVG have no early exit, so a one-shot run verifies the whole
    residue in a single pass.  Resumable/service callers pick their own.

    ``backend`` selects the physical layer — ``run_plan(plan,
    backend="device")`` executes the same plan over the store's
    device-resident masks and CHI with the CUDA kernels.
    """
    plan.validate()
    kind = plan.kind
    if not use_index:
        return _run_scan(store, plan, provided_rois, positions)
    if verify_batch is None:
        ranked = kind in ("topk", "filtered_topk") or (
            kind == "scalar_agg" and plan.agg.upper() in ("MIN", "MAX"))
        verify_batch = 256 if ranked else max(len(store), 1)
    run = compile_plan(store, plan, provided_rois=provided_rois,
                       verify_batch=verify_batch, bounds_hook=bounds_hook,
                       positions=positions, bounds=bounds, backend=backend)
    run.ensure(plan.k)
    if kind in ("topk", "filtered_topk"):
        ids, scores = run.result()
        return (ids, scores), run.stats
    return run.result(), run.stats


def _run_scan(store, plan: LogicalPlan, provided_rois, positions=None):
    """The ``use_index=False`` baseline: exact evaluation of everything."""
    kind = plan.kind
    common = dict(mask_types=plan.mask_types,
                  group_by_image=plan.grouped,
                  provided_rois=provided_rois, use_index=False,
                  positions=positions)
    if kind == "filter":
        return engine.filter_query(store, plan.predicate, **common)
    if kind == "topk":
        ids, scores, stats = engine.topk_query(
            store, plan.order_by, plan.k, desc=plan.desc, **common)
        return (ids, scores), stats
    if kind == "filtered_topk":
        ids, scores, stats = engine.filtered_topk_query(
            store, plan.predicate, plan.order_by, plan.k, desc=plan.desc,
            **common)
        return (ids, scores), stats
    common.pop("group_by_image")
    return engine.scalar_agg(store, plan.agg_expr, plan.agg, **common)


__all__ = ["LogicalPlan", "compile_plan", "run_plan", "simplify_predicate"]
