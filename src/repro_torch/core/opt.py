"""Cost-based filter optimization over the CHI pyramid (DESIGN.md §13).

The filter phase of every query decides candidates from index bytes alone;
this module decides *which* index bytes.  Two independent switches:

* **pyramid** — each conjunct of the WHERE clause starts its bounds pass at
  a coarse CHI tier (the strided subsample the store materializes per
  :attr:`~repro_torch.core.chi.CHIConfig.tier_grids`) and only still-undecided
  candidates refine downward.  Soundness is by construction — coarse
  bounds contain fine bounds (:func:`repro_torch.core.chi.tier_slice`) — and the
  finest rung re-evaluates the residue with exactly the classic bounds, so
  the final three-valued verdicts are bit-identical to plan-order
  evaluation while most candidates are decided in a fraction of the index
  bytes.
* **reorder** — conjuncts are evaluated cheapest-and-most-selective first
  instead of plan order.  Because ``And`` verdicts combine commutatively
  (accept = all accept, reject = any reject) any order yields the same
  final verdicts; a selective conjunct up front shrinks the candidate set
  every later conjunct (and the verification residue) pays for.

The selectivity estimates come from index statistics that already exist:
the CHI corner row ``table[:, -1, -1, :]`` is each mask's whole-image
value CDF (:meth:`~repro_torch.core.store.MaskStore.chi_value_stats`), so a CP
leaf's value is estimated as the bin-midpoint CDF fraction times its ROI
area — no mask bytes, no extra build pass.  Tier choice additionally uses
the per-tier spatial alignment slack
(:func:`repro_torch.core.chi.tier_alignment_fracs`): a predicate whose estimated
margin from its threshold is large relative to a tier's slack is predicted
to be decided there, and the start tier minimizes predicted total index
bytes down the ladder.  Estimate error is exported as the
``masksearch_selectivity_abs_error`` histogram on ``/metrics``.

The engine consumes :func:`plan_filter` (see
:func:`repro_torch.core.engine._decide_pred`); :func:`configure` scopes either
switch for tests and benchmarks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np

from ..obs.metrics import get_registry
from . import chi as chi_lib
from .exprs import (And, BinOp, Cmp, Const, CP, MaskEvalContext, Not, Or,
                    Pred, RoiArea, TypeIn)

__all__ = ["configure", "plan_filter", "flatten_and", "ConjunctPlan",
           "estimate_values", "observe_selectivity_error"]

#: Module switches — both on by default; scope overrides with configure().
PYRAMID = True
REORDER = True

#: Neutral reject estimate for conjuncts the mini-interpreter cannot see
#: through (unsupported node kinds): no reorder preference, coarsest start.
NEUTRAL_REJECT = 0.5

_SELECTIVITY_ERROR = get_registry().histogram(
    "masksearch_selectivity_abs_error",
    "Absolute error of the optimizer's per-conjunct selectivity estimate "
    "(estimated vs. actual bound-rejected fraction of evaluated candidates)",
    buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 1.0))
# materialize the unlabeled child so /metrics exports the (empty) family
# before the first ladder run — scrapers see the series exists
_SELECTIVITY_ERROR.labels()


def observe_selectivity_error(err: float) -> None:
    _SELECTIVITY_ERROR.observe(float(err))


@contextlib.contextmanager
def configure(pyramid: Optional[bool] = None, reorder: Optional[bool] = None):
    """Scope the optimizer switches (None leaves a switch untouched)::

        with opt.configure(pyramid=False, reorder=False):
            ...   # classic fixed plan-order, single-grid bounds
    """
    global PYRAMID, REORDER
    prev = (PYRAMID, REORDER)
    if pyramid is not None:
        PYRAMID = bool(pyramid)
    if reorder is not None:
        REORDER = bool(reorder)
    try:
        yield
    finally:
        PYRAMID, REORDER = prev


def flatten_and(pred: Pred) -> list:
    """Top-level conjuncts of a predicate tree, in plan order."""
    if isinstance(pred, And):
        return flatten_and(pred.left) + flatten_and(pred.right)
    return [pred]


@dataclasses.dataclass
class ConjunctPlan:
    """One conjunct's optimizer decision (also the EXPLAIN report row)."""

    index: int                    # position in the original plan order
    pred: Pred
    start_tier: int               # coarsest ladder rung to evaluate first
    cost: float                   # relative bounds-pass cost (CHI passes)
    est_reject: Optional[float]   # estimated bound-rejected fraction
    est_accept: Optional[float]
    classic: bool = False         # decide via the run's full finest bounds
                                  # (expression shared with the ranking, or
                                  # bounds already memoized on the run)


# ---------------------------------------------------------------------------
# Selectivity estimation (index statistics only — no mask bytes)
# ---------------------------------------------------------------------------


def _cdf_fraction(stats: np.ndarray, cfg, lv: float, uv: float):
    """Per-mask (inner, outer) fraction of pixels with value in [lv, uv),
    from the whole-image CDF rows (``chi_value_stats``) at the same four
    clipped value edges the bounds pass resolves to."""
    kl_in, ku_in, kl_out, ku_out = chi_lib.value_ks4(cfg, lv, uv)
    total = np.maximum(stats[:, -1].astype(np.float64), 1.0)
    inner = np.maximum(stats[:, ku_in] - stats[:, kl_in], 0) / total
    outer = np.maximum(stats[:, ku_out] - stats[:, kl_out], 0) / total
    return inner, outer


def estimate_values(node, ctx: MaskEvalContext):
    """Per-mask point estimate of a value expression, or None when a node
    kind is outside the mini-interpreter (Const / CP / RoiArea / BinOp).

    A CP leaf estimates as the midpoint of its inner/outer CDF fractions
    times its ROI area — exact for full-image aligned queries, a uniform-
    spatial-density approximation otherwise.
    """
    if isinstance(node, Const):
        return np.full(len(ctx.positions), float(node.value))
    if isinstance(node, RoiArea):
        rois = ctx.resolve_rois(node.roi, ctx.positions)
        return _roi_areas(rois)
    if isinstance(node, CP):
        store = ctx.store
        if not hasattr(store, "chi_value_stats"):
            return None
        stats = store.chi_value_stats()[np.asarray(ctx.positions)]
        inner, outer = _cdf_fraction(stats, ctx.cfg, node.lv, node.uv)
        rois = ctx.resolve_rois(node.roi, ctx.positions)
        return 0.5 * (inner + outer) * _roi_areas(rois)
    if isinstance(node, BinOp):
        left = estimate_values(node.left, ctx)
        right = estimate_values(node.right, ctx)
        if left is None or right is None:
            return None
        if node.op == "+":
            return left + right
        if node.op == "-":
            return left - right
        if node.op == "*":
            return left * right
        if node.op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(right != 0, left / np.where(right != 0,
                                                           right, 1.0), 0.0)
            return out
        return None
    return None


def _roi_areas(rois: np.ndarray) -> np.ndarray:
    rois = np.asarray(rois, np.int64)
    h = np.maximum(rois[:, 2] - rois[:, 0], 0)
    w = np.maximum(rois[:, 3] - rois[:, 1], 0)
    return (h * w).astype(np.float64)


def _cmp_margins(cmp: Cmp, values: np.ndarray) -> np.ndarray:
    """Normalized distance of each mask's estimated value from the
    comparison threshold — the cushion that must exceed the bounds'
    relative slack for a tier to decide the mask."""
    t = float(cmp.threshold)
    scale = np.maximum(np.maximum(np.abs(values), abs(t)), 1.0)
    return np.abs(values - t) / scale


def _estimate_pred(pred: Pred, ctx: MaskEvalContext):
    """(est_accept, est_reject, margins) for one conjunct subtree.

    Fractions are in [0, 1]; margins is the per-mask normalized threshold
    cushion (the minimum over Cmp leaves for composite subtrees — a mask
    is undecided if *any* leaf is).  None components mean "no estimate".
    """
    if isinstance(pred, Cmp):
        values = estimate_values(pred.expr, ctx)
        if values is None or not len(values):
            return None, None, None
        sat = np.asarray(
            {"<": values < pred.threshold, "<=": values <= pred.threshold,
             ">": values > pred.threshold,
             ">=": values >= pred.threshold}[pred.op])
        acc = float(sat.mean())
        return acc, 1.0 - acc, _cmp_margins(pred, values)
    if isinstance(pred, TypeIn):
        # Metadata-exact: no CHI involved, never unknown.
        types = ctx.store.meta["mask_type"][np.asarray(ctx.positions)]
        acc = float(np.isin(types, np.asarray(pred.types)).mean()) \
            if len(types) else 0.0
        return acc, 1.0 - acc, None
    if isinstance(pred, Not):
        a, r, m = _estimate_pred(pred.child, ctx)
        return r, a, m
    if isinstance(pred, (And, Or)):
        la, lr, lm = _estimate_pred(pred.left, ctx)
        ra, rr, rm = _estimate_pred(pred.right, ctx)
        if la is None or ra is None:
            return None, None, None
        margins = (lm if rm is None else rm if lm is None
                   else np.minimum(lm, rm))
        if isinstance(pred, And):
            return la * ra, 1.0 - (1.0 - lr) * (1.0 - rr), margins
        return 1.0 - (1.0 - la) * (1.0 - ra), lr * rr, margins
    return None, None, None


# ---------------------------------------------------------------------------
# Tier choice (predicted index bytes down the ladder)
# ---------------------------------------------------------------------------


def _tier_slacks(pred: Pred, ctx: MaskEvalContext, tiers) -> dict:
    """Per-tier relative bounds slack for one conjunct: the worst CP
    leaf's spatial misalignment at that tier plus its (tier-independent)
    value-bin slack.  A mask whose estimated threshold margin exceeds the
    slack is predicted to be decided at that tier."""
    slacks = {g: 0.0 for g in tiers}
    for term in pred.cp_terms():
        if not isinstance(term, CP):
            return {g: np.inf for g in tiers}   # no model → never decided
        rois = ctx.resolve_rois(term.roi, ctx.positions)
        v_slack = 0.0
        store = ctx.store
        if hasattr(store, "chi_value_stats"):
            stats = store.chi_value_stats()[np.asarray(ctx.positions)]
            inner, outer = _cdf_fraction(stats, ctx.cfg, term.lv, term.uv)
            v_slack = float(np.mean(outer - inner)) if len(inner) else 0.0
        for g in tiers:
            inner_f, outer_f = chi_lib.tier_alignment_fracs(ctx.cfg, g, rois)
            s_slack = float(np.mean(outer_f - inner_f)) if len(inner_f) \
                else 0.0
            slacks[g] = max(slacks[g], s_slack + v_slack)
    return slacks


def _tier_row_bytes(cfg, g: int) -> int:
    return (g + 1) * (g + 1) * (cfg.num_bins + 1) * 4


def _choose_start_tier(pred: Pred, ctx: MaskEvalContext, tiers,
                       margins) -> int:
    """Ladder start minimizing predicted index bytes: starting coarse pays
    extra cheap rungs for the undecided residue; starting fine pays the
    full-resolution row for every candidate.  Ties break to the coarser
    start (deterministic).  No margins → start coarsest: the whole coarse
    ladder costs a fraction of one finest pass, so the downside is bounded
    while the upside is most candidates deciding early."""
    if margins is None or not len(margins):
        return tiers[0]
    slacks = _tier_slacks(pred, ctx, tiers)
    best, best_cost = tiers[-1], None
    for i, start in enumerate(tiers):
        cost, undecided = 0.0, 1.0
        for g in tiers[i:]:
            cost += undecided * _tier_row_bytes(ctx.cfg, g)
            undecided = float(np.mean(margins < slacks[g]))
        if best_cost is None or cost < best_cost:
            best, best_cost = start, cost
    return best


# ---------------------------------------------------------------------------
# The filter plan
# ---------------------------------------------------------------------------


def plan_filter(pred: Pred, ctx, shared_exprs=(), memo_exprs=()) -> \
        Optional[list]:
    """Optimizer decisions for one WHERE clause, in evaluation order, or
    None when the optimizer does not apply (switches off, non-per-mask
    context, or a single-tier pyramid) and the engine should run the
    classic plan-order decide.

    Conjuncts whose value expressions are shared with the ranking
    expression (or already memoized on the run) are marked ``classic``:
    they decide from the run's full finest bounds so the shared pass is
    computed once and stays memoized for the ranking frontier.
    """
    if not (PYRAMID or REORDER):
        return None
    if not isinstance(ctx, MaskEvalContext) or getattr(ctx, "tier", None):
        return None
    tiers = ctx.cfg.tier_grids
    if len(tiers) < 2:
        return None
    conjuncts = flatten_and(pred)
    shared = set(shared_exprs) | set(memo_exprs)
    plans = []
    for i, c in enumerate(conjuncts):
        est_accept, est_reject, margins = _estimate_pred(c, ctx)
        exprs = c.value_exprs()
        classic = any(e in shared for e in exprs)
        # TypeIn-only conjuncts touch metadata, not CHI — near-free.
        cost = float(max(len(exprs), 1)) if exprs else 0.25
        if classic or not PYRAMID:
            start = tiers[-1]
        else:
            start = _choose_start_tier(c, ctx, tiers, margins)
        plans.append(ConjunctPlan(index=i, pred=c, start_tier=start,
                                  cost=cost, est_reject=est_reject,
                                  est_accept=est_accept, classic=classic))
    if REORDER:
        plans.sort(key=lambda p: (-(p.est_reject if p.est_reject is not None
                                    else NEUTRAL_REJECT) / p.cost, p.index))
    return plans
