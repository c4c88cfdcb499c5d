"""The filter–verification execution framework (paper §2).

Every query runs in two phases:

1. **Filter** — CHI-derived bounds are computed for every candidate (no mask
   bytes touched).  Candidates whose bounds already decide the predicate are
   accepted/pruned outright; bound-coincident candidates (``lb == ub``) have
   *known exact scores* for free.  Boolean predicate trees prune through
   three-valued logic (:meth:`repro_torch.core.exprs.Pred.decide`): a conjunction
   rejects as soon as one conjunct must fail, a disjunction accepts as soon
   as one disjunct must hold.
2. **Verification** — only the undecided residue is loaded from the mask
   tier and evaluated exactly.  For Top-K, verification proceeds in rounds of
   ``verify_batch`` ordered by most-promising bound, and stops as soon as the
   running k-th-best exact score dominates every unverified candidate's bound
   (the paper's incremental-threshold pruning, recast as fixed-size device
   batches — see DESIGN.md §3 on why batches instead of a per-mask heap).

Physical execution is uniform: every run object — :class:`FilterRun`,
:class:`TopKRun`, :class:`FilteredTopKRun`, :class:`ScalarAggRun`,
:class:`MinMaxAggRun`, and the dual-mask :class:`PairFilterRun` /
:class:`PairTopKRun` / :class:`PairFilteredTopKRun` (DESIGN.md §9) —
presents ``target / take_batch / apply_exact /
finished / result`` (DESIGN.md §6), so sessions resume any of them and the
service scheduler fuses their verification batches without knowing which
operator it is driving.  The runs themselves are backend-agnostic drivers:
every physical operation (bounds, exact counts, the ranking frontier,
MASK_AGG counts, pair counts) goes through an
:class:`repro_torch.core.backend.ExecBackend` — host NumPy or
single-device resident HBM — selected per run (DESIGN.md §7).

All runs expose :class:`ExecStats` telling exactly how much I/O the index
avoided — the quantity behind the paper's 100× claim.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..obs import trace as _trace
from . import opt as opt_lib
from .backend import get_backend
from .exprs import (Cmp, CP, GroupEvalContext, MaskEvalContext, Node,
                    PairEvalContext, PairTerm, Pred, eval_with_counts,
                    is_group_expr, pair_roles_of, tier_context)
from .store import StaleRunError


@dataclasses.dataclass
class ExecStats:
    n_candidates: int = 0
    n_decided_by_bounds: int = 0      # accepted or pruned without loading
    n_verified: int = 0               # masks actually loaded + scanned
    n_rounds: int = 0                 # top-k verification rounds
    n_dropped_masks: int = 0          # ragged-group members excluded from
                                      # GROUP BY (see _make_context)
    bytes_loaded: int = 0             # store bytes metered for this run
    bytes_saved: int = 0              # served from the shared-load cache
    chi_bytes: int = 0                # index bytes the bounds passes touched
    bound_time_s: float = 0.0
    verify_time_s: float = 0.0

    @property
    def load_fraction(self) -> float:
        return self.n_verified / max(self.n_candidates, 1)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["load_fraction"] = self.load_fraction
        return d

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


def _chi_row_nbytes(ctx, tier: Optional[int] = None) -> int:
    """Bytes of CHI table one candidate's bounds pass touches (pair
    candidates touch both roles' rows); at pyramid tier ``tier`` the row is
    the (g+1)²·(NB+1) strided subsample.  Best-effort: 0 when the store
    doesn't expose its chunked CHI layout."""
    chunks = getattr(ctx.store, "chi_chunks", None)
    if not chunks:
        return 0
    row = chunks[0]
    if tier is None:
        per = int(np.prod(row.shape[1:])) * row.dtype.itemsize
    else:
        per = (tier + 1) * (tier + 1) * row.shape[-1] * row.dtype.itemsize
    return per * (2 if isinstance(ctx, PairEvalContext) else 1)


def _make_context(store, exprs, group_by_image: bool, positions, mask_types,
                  provided_rois, partial_rows: bool = True, backend=None):
    """Build the evaluation context + the id array that results refer to.

    The unit of evaluation comes from the expressions: pair terms →
    :class:`PairEvalContext` over per-image (role_a, role_b) mask rows;
    MASK_AGG terms (or explicit grouping) → :class:`GroupEvalContext`;
    otherwise :class:`MaskEvalContext` per mask.

    Returns ``(ctx, ids, n_dropped)`` — ``n_dropped`` counts masks excluded
    from ragged image groups (grouped evaluation needs one rectangular
    ``(n_groups, size)`` block, so images with more masks than the smallest
    group keep only their first ``size``; the caller surfaces the count in
    ``ExecStats.n_dropped_masks`` instead of losing it silently).  For pair
    contexts it counts role-A/role-B masks excluded from evaluation —
    duplicates beyond the first per (image, role) plus masks whose image
    lacks the partner role.
    """
    exprs = tuple(exprs)
    roles = pair_roles_of(exprs)
    if roles is not None:
        # Engine-level callers bypass LogicalPlan.validate — enforce the
        # same invariants here so they get clear errors, not silently
        # dropped restrictions or a TypeError deep in bounds().
        mixed = [t for e in exprs for t in e.cp_terms()
                 if not isinstance(t, PairTerm)]
        if mixed:
            raise ValueError(
                "a dual-mask (pair) query cannot mix in per-mask CP or "
                f"MASK_AGG terms (offending: {mixed[0]!r})")
        if mask_types is not None:
            raise ValueError(
                "pair queries select their masks by role (the two "
                "mask_types named in the pair terms); drop mask_types")
        return _make_pair_context(store, roles, positions, provided_rois,
                                  backend)
    grouped = _grouped_for(exprs, group_by_image)
    if grouped:
        sel = (store.select(mask_type=mask_types) if mask_types is not None
               else np.arange(len(store)))
        if positions is not None:
            sel = np.intersect1d(sel, positions)
        img = store.meta["image_id"][sel]
        order = np.argsort(img, kind="stable")
        sel, img = sel[order], img[order]
        uniq, starts, counts = np.unique(img, return_index=True,
                                         return_counts=True)
        n_dropped = 0
        if len(counts):
            size = counts.min()
            if counts.max() != size:
                # ragged groups: keep the first `size` per image
                # (deterministic); the rest are *dropped from evaluation*
                # and accounted in ExecStats.n_dropped_masks.
                n_dropped = int(counts.sum() - size * len(counts))
                keep = np.concatenate(
                    [sel[s:s + size] for s in starts])
                groups = keep.reshape(-1, size)
            else:
                groups = sel.reshape(-1, size)
        else:
            groups = sel.reshape(0, 1)
        ctx = GroupEvalContext(store, groups, uniq, provided_rois)
        ctx.backend = backend
        return ctx, uniq, n_dropped
    if positions is None:
        positions = (store.select(mask_type=mask_types)
                     if mask_types is not None else np.arange(len(store)))
    ctx = MaskEvalContext(store, positions, provided_rois,
                          partial_rows=partial_rows)
    ctx.backend = backend
    return ctx, store.meta["mask_id"][positions], 0


def _make_pair_context(store, roles, positions, provided_rois, backend):
    """Per-image pairing: for each image present in **both** roles, pair
    its first role-A mask with its first role-B mask (ascending store
    position — deterministic across runs and backends)."""
    sel_a = store.select(mask_type=roles[0])
    sel_b = store.select(mask_type=roles[1])
    if positions is not None:
        positions = np.asarray(positions)
        sel_a = np.intersect1d(sel_a, positions)
        sel_b = np.intersect1d(sel_b, positions)
    uniq_a, first_a = np.unique(store.meta["image_id"][sel_a],
                                return_index=True)
    uniq_b, first_b = np.unique(store.meta["image_id"][sel_b],
                                return_index=True)
    common, ia, ib = np.intersect1d(uniq_a, uniq_b, return_indices=True)
    pos_a = sel_a[first_a[ia]]
    pos_b = sel_b[first_b[ib]]
    n_dropped = int(len(sel_a) + len(sel_b) - 2 * len(common))
    ctx = PairEvalContext(store, pos_a, pos_b, common, roles, provided_rois)
    ctx.backend = backend
    return ctx, common, n_dropped


def _grouped_for(exprs, group_by_image: bool) -> bool:
    return group_by_image or any(is_group_expr(e) for e in exprs)


# ---------------------------------------------------------------------------
# The uniform resumable run
# ---------------------------------------------------------------------------


class _VerifyRun:
    """Shared machinery of resumable verification runs (DESIGN.md §3/§6).

    Construction runs the bounds pass — per distinct value expression,
    through an optional ``bounds_hook`` (``get(expr) -> (lb, ub) | None``,
    ``put(expr, lb, ub)``) such as the service planner's bounds cache.
    Subclasses fill ``pending`` (candidate indices in verification-priority
    order) and implement :meth:`finished`, :meth:`_apply` and
    :meth:`result`.  Verification is then driven either self-contained
    (:meth:`ensure`) or externally by the service scheduler, which pairs
    :meth:`take_batch` with :meth:`apply_exact` to fuse batches from many
    concurrent runs into one kernel pass; :meth:`cp_terms` and
    :meth:`fused_values` are the fusion contract.
    """

    def __init__(self, store, exprs, *,
                 positions: Optional[np.ndarray] = None, mask_types=None,
                 group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 verify_batch: int = 256, bounds_hook=None, backend=None):
        self.store = store
        self.exprs = tuple(exprs)
        self.verify_batch = max(int(verify_batch), 1)
        self.backend = get_backend(store, backend)
        # Snapshot consistency (DESIGN.md §8): the run pins the epoch it was
        # planned at and evaluates against an epoch-pinned store view, so a
        # mutation mid-run either lets the run finish on retained data
        # (memory tiers; untouched disk ids) or raises a clean
        # StaleRunError — never a silent mix of old and new bytes.
        self.epoch = getattr(store, "epoch", 0)
        snap = store.snapshot() if hasattr(store, "snapshot") else store
        self.ctx, self.ids, n_dropped = _make_context(
            snap, self.exprs, group_by_image, positions, mask_types,
            provided_rois, backend=self.backend)
        if (isinstance(self.ctx, MaskEvalContext) and
                len({t for e in self.exprs for t in e.cp_terms()}) > 1):
            # ROI-row partial loads only pay off for a single distinct CP
            # term; a multi-term run shares one full-mask load instead.
            self.ctx.partial_rows = False
        self.stats = ExecStats(n_candidates=len(self.ids),
                               n_dropped_masks=n_dropped)
        self._bounds_hook = bounds_hook
        self._bounds_memo: dict = {}
        # Filled by _decide_pred when the cost-based optimizer ran: conjunct
        # order, per-conjunct tier ladders, estimated vs. actual selectivity
        # (surfaced by EXPLAIN ANALYZE).
        self.opt_report: Optional[dict] = None
        self.pending = np.empty(0, dtype=np.int64)
        self.cursor = 0

    @property
    def n(self) -> int:
        return len(self.ids)

    # -- bounds ------------------------------------------------------------
    def expr_bounds(self, expr: Node):
        """(lb, ub) float64 arrays for ``expr`` over all candidates, memoized
        per run and (optionally) cached across runs by the bounds hook."""
        if expr in self._bounds_memo:
            return self._bounds_memo[expr]
        t0 = time.perf_counter()
        finest = self.ctx.cfg.grid
        with _trace.span("bounds") as sp:
            cached = (self._bounds_hook.get(expr, tier=finest)
                      if self._bounds_hook else None)
            if cached is not None:
                lb, ub = cached
            else:
                lb, ub = self.backend.bounds(self.ctx, expr)
                lb = np.asarray(lb, np.float64)
                ub = np.asarray(ub, np.float64)
                if self._bounds_hook is not None:
                    self._bounds_hook.put(expr, lb, ub, tier=finest)
            nbytes = (0 if cached is not None
                      else self.n * _chi_row_nbytes(self.ctx))
            sp.set(expr=repr(expr), candidates=self.n,
                   cached=cached is not None, chi_bytes=nbytes)
        self.stats.chi_bytes += nbytes
        self.stats.bound_time_s += time.perf_counter() - t0
        self._bounds_memo[expr] = (lb, ub)
        return lb, ub

    # -- the uniform drive interface --------------------------------------
    def target(self, k: Optional[int] = None) -> Optional[int]:
        """Set/raise the finality target (top-k runs); no-op elsewhere, so
        callers can drive any run kind uniformly."""
        return k

    def finished(self) -> bool:
        raise NotImplementedError

    def result(self):
        raise NotImplementedError

    def cp_terms(self) -> list:
        """All CP terms this run's verification evaluates (fusion input)."""
        return [t for e in self.exprs for t in e.cp_terms()]

    def exact_values(self, batch: np.ndarray):
        """Self-contained exact evaluation of one batch (loads mask bytes)."""
        raise NotImplementedError

    def _self_counts(self, batch: np.ndarray):
        """Per-term exact counts for ``batch``, evaluated **once per
        distinct term** by the run's backend (a predicate and a ranking
        sharing an expression share its loads/kernel rows even in
        self-verification), or None when the run isn't a pure per-mask CP
        or pure pair-term evaluation."""
        terms = set(self.cp_terms())
        if isinstance(self.ctx, PairEvalContext):
            if terms and all(isinstance(t, PairTerm) for t in terms):
                return self.backend.pair_verify_counts(self.ctx, batch, terms)
            return None
        if not isinstance(self.ctx, MaskEvalContext):
            return None
        if terms and all(isinstance(t, CP) for t in terms):
            if getattr(self.store, "packed", False):
                # Packed tier: the bounds+verify megakernel answers every
                # term of the batch in ONE launch, passing CHI-decided
                # entries through from the run's memoized bounds (a term
                # whose expression-level bounds were never memoized is just
                # treated as undecided — no extra bounds pass).
                return self.backend.fused_verify_counts(
                    self.ctx, batch, terms, self._bounds_memo.get)
            return self.backend.verify_counts(self.ctx, batch, terms)
        return None

    def fused_values(self, batch: np.ndarray, counts: dict):
        """Exact evaluation when every CP term's count was precomputed by a
        fused multi-query kernel pass (``counts``: CP node → array aligned
        with ``batch``)."""
        raise NotImplementedError

    def _apply(self, batch: np.ndarray, values) -> None:
        raise NotImplementedError

    def fresh(self) -> bool:
        """Whether the store is still at the epoch this run was planned at."""
        return self.epoch == getattr(self.store, "epoch", 0)

    def resumable(self) -> bool:
        """Whether the run can still be driven to completion: fresh, already
        finished (no store access needed — results are run-local), or its
        epoch-pinned snapshot can serve every remaining verification load
        (host backend only — device residency tracks the live epoch)."""
        if self.fresh():
            return True
        rest = self.pending[self.cursor:]
        if not len(rest) or self.finished():
            return True
        if self.backend.name != "host":
            return False
        snap = self.ctx.store
        if not hasattr(snap, "can_serve"):
            return True
        if isinstance(self.ctx, MaskEvalContext):
            positions = self.ctx.positions[rest]
        elif isinstance(self.ctx, PairEvalContext):
            positions = np.concatenate([self.ctx.pos_a[rest],
                                        self.ctx.pos_b[rest]])
        else:
            positions = self.ctx.groups[rest].reshape(-1)
        return snap.can_serve(positions)

    def take_batch(self) -> np.ndarray:
        """Peek the next pending chunk; caller must ``apply_exact`` it —
        the cursor advances only when the batch's exact values are applied,
        so a verification failure (e.g. a :class:`StaleRunError` from the
        snapshot load) leaves the batch pending instead of silently
        dropping its candidates from the result.

        A stale run (the store mutated since planning) can only resume on
        the host backend, whose loads go through the run's epoch-pinned
        snapshot; device residency has been refreshed past the pinned
        epoch, so resuming there would silently mix old bounds with new
        bytes — raise instead."""
        if (self.cursor < len(self.pending) and not self.fresh()
                and self.backend.name != "host"):
            raise StaleRunError(
                f"run pinned at epoch {self.epoch} cannot resume on "
                f"backend {self.backend.name!r}: store moved to epoch "
                f"{self.store.epoch} and its resident masks were refreshed")
        return self.pending[self.cursor:self.cursor + self.verify_batch]

    def apply_exact(self, batch: np.ndarray, values) -> None:
        self._apply(batch, values)
        self.cursor += len(batch)
        self.stats.n_verified += len(batch)
        self.stats.n_rounds += 1

    def self_verify(self, batch: np.ndarray) -> None:
        cache = self.store.cache_stats
        io0 = self.store.io.bytes_read
        saved0, hits0 = cache.bytes_saved, cache.hits
        t0 = time.perf_counter()
        with _trace.span("verify.round") as sp:
            self.apply_exact(batch, self.exact_values(batch))
            sp.set(batch=len(batch),
                   bytes_loaded=self.store.io.bytes_read - io0,
                   bytes_saved=cache.bytes_saved - saved0,
                   cache_hits=cache.hits - hits0)
        self.stats.verify_time_s += time.perf_counter() - t0
        self.stats.bytes_loaded += self.store.io.bytes_read - io0
        self.stats.bytes_saved += cache.bytes_saved - saved0

    def _drain(self) -> None:
        while not self.finished():
            batch = self.take_batch()
            if not len(batch):
                break
            self.self_verify(batch)

    def ensure(self, k: Optional[int] = None) -> None:
        """Drive verification to completion (optionally raising the target)."""
        if k is not None:
            self.target(k)
        self._drain()


def _as_pred(expr_or_pred, op, threshold) -> Pred:
    if isinstance(expr_or_pred, Pred):
        if op is not None or threshold is not None:
            raise ValueError("op/threshold are implied by a predicate tree")
        return expr_or_pred
    return Cmp(expr_or_pred, op, threshold)


def _ladder_bounds_of(run, sub, g: int, finest: int):
    """The ``bounds_of`` callable for one ladder rung: the run's backend
    over the tier subcontext, traced as ``bounds.tier`` spans (distinct
    from the classic full-pass ``bounds`` spans, whose candidate/byte
    attributes describe the whole candidate set)."""

    def bounds_of(expr):
        t0 = time.perf_counter()
        with _trace.span("bounds.tier") as sp:
            lb, ub = run.backend.bounds(sub, expr)
            lb = np.asarray(lb, np.float64)
            ub = np.asarray(ub, np.float64)
            nbytes = len(sub.positions) * _chi_row_nbytes(sub, g)
            sp.set(expr=repr(expr), tier=g, candidates=len(sub.positions),
                   chi_bytes=nbytes)
        run.stats.chi_bytes += nbytes
        run.stats.bound_time_s += time.perf_counter() - t0
        return lb, ub

    return bounds_of


def _decide_pred(run, pred: Pred, shared_exprs=()):
    """Three-valued WHERE decision, through the cost-based optimizer when
    it applies (``core/opt.py``, DESIGN.md §13): conjuncts are evaluated
    cheapest-and-most-selective first, each starting at its chosen CHI
    pyramid tier and refining only the still-undecided candidates downward.

    The final (accept, reject) verdicts are bit-identical to the classic
    plan-order decide at the finest grid: coarse bounds contain fine bounds
    so coarse decisions are monotone, the finest rung re-evaluates every
    still-undecided candidate with exactly the classic bounds, and a
    candidate skipped because an earlier conjunct rejected it is rejected
    under any conjunct order.  The service's bounds-cache path keeps the
    classic decide so its finest-tier entries stay shared across refined
    queries.  Sets ``run.opt_report`` when the optimizer ran.
    """
    ctx = run.ctx
    plans = None
    if run._bounds_hook is None:
        plans = opt_lib.plan_filter(pred, ctx, shared_exprs=shared_exprs,
                                    memo_exprs=run._bounds_memo)
    if plans is None:
        accept, reject = pred.decide(run.expr_bounds, ctx)
        return np.asarray(accept), np.asarray(reject)
    tiers = ctx.cfg.tier_grids
    finest = tiers[-1]
    n = run.n
    accept = np.ones(n, dtype=bool)
    reject = np.zeros(n, dtype=bool)
    report = []
    for plan in plans:
        c = plan.pred
        live = np.nonzero(~reject)[0]
        a_c = np.zeros(n, dtype=bool)
        r_c = np.zeros(n, dtype=bool)
        tier_rows = []
        if plan.classic:
            a, r = c.decide(run.expr_bounds, ctx)
            a_c |= np.asarray(a, bool)
            r_c |= np.asarray(r, bool)
            evaluated = n
            rejected = int(r_c.sum())
        else:
            undecided = live
            for g in tiers[tiers.index(plan.start_tier):]:
                if not len(undecided):
                    break
                sub = tier_context(ctx, undecided,
                                   None if g == finest else g)
                a, r = c.decide(_ladder_bounds_of(run, sub, g, finest), sub)
                a = np.asarray(a, bool)
                r = np.asarray(r, bool)
                a_c[undecided[a]] = True
                r_c[undecided[r]] = True
                tier_rows.append({"grid": int(g),
                                  "candidates": int(len(undecided)),
                                  "accepted": int(a.sum()),
                                  "rejected": int(r.sum())})
                undecided = undecided[~(a | r)]
            evaluated = len(live)
            rejected = int(r_c[live].sum())
        actual_reject = rejected / evaluated if evaluated else None
        if plan.est_reject is not None and evaluated:
            opt_lib.observe_selectivity_error(
                abs(plan.est_reject - actual_reject))
        report.append({
            "pred": repr(c), "plan_index": plan.index,
            "start_tier": int(plan.start_tier), "classic": plan.classic,
            "est_reject": plan.est_reject, "actual_reject": actual_reject,
            "evaluated": evaluated, "tiers": tier_rows,
        })
        accept &= a_c
        reject |= r_c
    run.opt_report = {"order": [p.index for p in plans],
                      "reordered": [p.index for p in plans] !=
                      sorted(p.index for p in plans),
                      "tier_grids": [int(g) for g in tiers],
                      "conjuncts": report}
    return accept, reject


class FilterRun(_VerifyRun):
    """Resumable verification state for a filter query — a boolean predicate
    tree (or the legacy ``expr op threshold`` triple) whose bound-undecided
    residue is verified in chunks until exhausted."""

    def __init__(self, store, expr_or_pred, op: Optional[str] = None,
                 threshold: Optional[float] = None, *,
                 positions: Optional[np.ndarray] = None, mask_types=None,
                 group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 verify_batch: int = 256, bounds=None, bounds_hook=None,
                 backend=None):
        self.pred = _as_pred(expr_or_pred, op, threshold)
        # legacy surface for single-comparison plans
        if isinstance(self.pred, Cmp):
            self.expr = self.pred.expr
            self.op = self.pred.op
            self.threshold = self.pred.threshold
        else:
            self.expr, self.op, self.threshold = None, None, None
        super().__init__(store, self.pred.value_exprs(), positions=positions,
                         mask_types=mask_types, group_by_image=group_by_image,
                         provided_rois=provided_rois,
                         verify_batch=verify_batch, bounds_hook=bounds_hook,
                         backend=backend)
        if bounds is not None and self.expr is not None:
            self._bounds_memo[self.expr] = tuple(
                np.asarray(b, np.float64) for b in bounds)
        accept, reject = _decide_pred(self, self.pred)
        self.accept = np.asarray(accept).copy()
        self.pending = np.nonzero(~(accept | reject))[0]
        self.stats.n_decided_by_bounds = self.n - len(self.pending)

    def finished(self) -> bool:
        return self.cursor >= len(self.pending)

    def exact_values(self, batch):
        counts = self._self_counts(batch)
        if counts is not None:
            return self.fused_values(batch, counts)
        return self.pred.exact(self.ctx, batch)

    def fused_values(self, batch, counts):
        return self.pred.exact_with_counts(self.ctx, batch, counts)

    def _apply(self, batch: np.ndarray, values) -> None:
        self.accept[batch] = values

    def result(self) -> np.ndarray:
        return self.ids[self.accept]


def filter_query(store, expr_or_pred, op: Optional[str] = None,
                 threshold: Optional[float] = None, *,
                 positions: Optional[np.ndarray] = None,
                 mask_types=None, group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 use_index: bool = True, bounds=None, backend=None):
    """``SELECT {mask_id|image_id} WHERE predicate``.

    The predicate is either a :class:`repro_torch.core.exprs.Pred` tree or the
    legacy ``expr, op, threshold`` triple.  Returns ``(ids, stats)``.
    ``use_index=False`` is the full-scan baseline (the paper's "without
    MaskSearch").  ``bounds`` optionally supplies a precomputed ``(lb, ub)``
    pair for a single-comparison predicate (legacy service surface).
    """
    pred = _as_pred(expr_or_pred, op, threshold)
    if not use_index:
        ctx, ids, n_dropped = _make_context(store, pred.value_exprs(),
                                            group_by_image, positions,
                                            mask_types, provided_rois,
                                            partial_rows=False)
        n = len(ids)
        stats = ExecStats(n_candidates=n, n_dropped_masks=n_dropped)
        io_before = store.io.bytes_read
        t0 = time.perf_counter()
        keep = pred.exact(ctx, np.arange(n))
        stats.n_verified = n
        stats.verify_time_s = time.perf_counter() - t0
        stats.bytes_loaded = store.io.bytes_read - io_before
        return ids[keep], stats

    run = FilterRun(store, pred, positions=positions,
                    mask_types=mask_types, group_by_image=group_by_image,
                    provided_rois=provided_rois,
                    verify_batch=max(len(store), 1), bounds=bounds,
                    backend=backend)
    run.ensure()
    return run.result(), run.stats


# ---------------------------------------------------------------------------
# Top-K query
# ---------------------------------------------------------------------------


class TopKRun(_VerifyRun):
    """Resumable top-k verification state (the batched loop of §3, DESIGN.md).

    Construction runs the bounds pass only; verification is then driven
    either by :meth:`ensure` (the one-shot ``topk_query`` path) or
    externally, one :meth:`take_batch`/:meth:`apply_exact` round at a time
    (the service's sessions and fused scheduler).  The finality target ``k``
    can *grow* between rounds — :meth:`target` re-derives the static pruning
    frontier from the cached bounds, so a GUI's "next 25" costs only the
    extra verification batches, never a fresh bounds pass.

    The frontier is written once, predicate-aware: a plain top-k is the
    trivial case where every candidate is known to qualify (``p_true`` all
    set); :class:`FilteredTopKRun` re-derives ``p_true``/``p_false`` from a
    predicate tree and shares every line of the pruning machinery.
    """

    def __init__(self, store, expr: Node, *, desc: bool = True,
                 positions: Optional[np.ndarray] = None, mask_types=None,
                 group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 verify_batch: int = 256, bounds=None, bounds_hook=None,
                 backend=None, _pred_exprs=()):
        self.desc = desc
        self.expr = expr
        super().__init__(store, list(_pred_exprs) + [expr],
                         positions=positions,
                         mask_types=mask_types, group_by_image=group_by_image,
                         provided_rois=provided_rois,
                         verify_batch=verify_batch, bounds_hook=bounds_hook,
                         backend=backend)
        if bounds is not None:
            self._bounds_memo[expr] = tuple(
                np.asarray(b, np.float64) for b in bounds)
        self._init_qualification()
        self.lb, self.ub = self.expr_bounds(expr)
        # Scores: exact where bounds coincide, else pending verification.
        self.scores = np.where(self.lb == self.ub, self.lb, np.nan)
        self.known = ~np.isnan(self.scores)
        self._resolved0 = self._resolved().copy()
        self.k = 0
        self.alive = np.zeros(self.n, dtype=bool)

    def _init_qualification(self) -> None:
        """Plain top-k: every candidate trivially satisfies the (absent)
        predicate.  Overridden by FilteredTopKRun."""
        self.p_true = np.ones(self.n, dtype=bool)
        self.p_false = np.zeros(self.n, dtype=bool)
        self.p_known = np.ones(self.n, dtype=bool)

    def _resolved(self) -> np.ndarray:
        """Candidates needing no verification: predicate known-false, or
        predicate known (true) with an exact score."""
        return self.p_false | (self.p_known & self.known)

    def target(self, k: Optional[int] = None) -> int:
        """Set/raise the finality target to ``k`` (clamped to n) and
        re-derive the static pruning frontier.  Idempotent for equal k."""
        if k is None:
            return self.k
        k = min(int(k), self.n)
        if k == self.k:
            return k
        self.k = k
        n = self.n
        if n == 0 or k <= 0:
            self.alive = np.zeros(n, dtype=bool)
            self.pending = np.empty(0, dtype=np.int64)
            self.cursor = 0
            return k
        # Static pruning: a candidate can make top-k only if its optimistic
        # bound beats the k-th best pessimistic bound among candidates that
        # *definitely* qualify — so no possibly-qualifying candidate is
        # pruned on an assumption about another's unverified predicate.
        # The frontier selection itself is a backend primitive (host
        # np.partition; device torch.topk + float64 tie resolution).
        possible = ~self.p_false
        self.alive = self.backend.topk_candidates(self.lb, self.ub, k,
                                                  self.desc, self.p_true,
                                                  possible)
        self.stats.n_decided_by_bounds = int(
            n - np.count_nonzero(self.alive & ~self._resolved0))
        pending = np.nonzero(self.alive & ~self._resolved())[0]
        # verify most-promising first
        key = self.ub[pending] if self.desc else self.lb[pending]
        self.pending = pending[np.argsort(-key if self.desc else key,
                                          kind="stable")]
        self.cursor = 0
        return k

    def finished(self) -> bool:
        """True iff the current top-``k`` can no longer change."""
        have = np.nonzero(self.p_true & self.known & self.alive)[0]
        if len(have) >= self.k > 0:
            vals = self.scores[have]
            kth = (np.partition(vals, -self.k)[-self.k] if self.desc
                   else np.partition(vals, self.k - 1)[self.k - 1])
            rest = self.pending[self.cursor:]
            if len(rest) == 0:
                return True
            best_possible = (self.ub[rest].max() if self.desc
                             else self.lb[rest].min())
            # strict domination → no unverified candidate can displace top-k
            return ((self.desc and best_possible < kth) or
                    (not self.desc and best_possible > kth))
        return self.cursor >= len(self.pending)

    def exact_values(self, batch):
        counts = self._self_counts(batch)
        if counts is not None:
            return self.fused_values(batch, counts)
        return self.ctx.exact(self.expr, batch)

    def fused_values(self, batch, counts):
        return eval_with_counts(self.ctx, self.expr, batch, counts)

    def _apply(self, batch: np.ndarray, values) -> None:
        self.scores[batch] = values
        self.known[batch] = True

    def result(self, k: Optional[int] = None):
        """(ids, scores) of the current top-``k`` — call after :meth:`ensure`
        (or after the scheduler reports :meth:`finished`).  Ties break by
        candidate order, so paginated and one-shot runs agree exactly."""
        k = self.k if k is None else min(int(k), self.n)
        final = np.nonzero(self.p_true & self.known)[0]
        if len(final) == 0 or k <= 0:
            return self.ids[:0], self.scores[:0]
        vals = self.scores[final]
        order = final[_topk_order(vals, min(k, len(final)), self.desc)]
        return self.ids[order], self.scores[order]


def topk_query(store, expr: Node, k: int, *, desc: bool = True,
               positions: Optional[np.ndarray] = None,
               mask_types=None, group_by_image: bool = False,
               provided_rois: Optional[np.ndarray] = None,
               use_index: bool = True, verify_batch: int = 256,
               bounds=None, backend=None):
    """``SELECT ... ORDER BY expr {DESC|ASC} LIMIT k`` → (ids, scores, stats)."""
    if not use_index:
        ctx, ids, n_dropped = _make_context(store, [expr], group_by_image,
                                            positions, mask_types,
                                            provided_rois)
        n = len(ids)
        k = min(k, n)
        stats = ExecStats(n_candidates=n, n_dropped_masks=n_dropped)
        io_before = store.io.bytes_read
        t0 = time.perf_counter()
        exact = ctx.exact(expr, np.arange(n))
        order = _topk_order(exact, k, desc)
        stats.n_verified = n
        stats.verify_time_s = time.perf_counter() - t0
        stats.bytes_loaded = store.io.bytes_read - io_before
        return ids[order], exact[order], stats

    run = TopKRun(store, expr, desc=desc, positions=positions,
                  mask_types=mask_types, group_by_image=group_by_image,
                  provided_rois=provided_rois, verify_batch=verify_batch,
                  bounds=bounds, backend=backend)
    run.ensure(k)
    ids, scores = run.result()
    return ids, scores, run.stats


def _topk_order(values, k, desc):
    """Indices of the top-k, fully deterministic: ties break by ascending
    candidate position.  CP scores are integer pixel counts, so boundary
    ties are the norm — argpartition's arbitrary pick among equals would
    let a paginated run (whose known-set grows between pages) select a
    different tied candidate than a one-shot run."""
    v = -values if desc else values
    order = np.lexsort((np.arange(len(v)), v))  # primary v, then index
    return order[:k]


# ---------------------------------------------------------------------------
# Filtered Top-K: predicate residue feeds the ranking frontier
# ---------------------------------------------------------------------------


class FilteredTopKRun(TopKRun):
    """``WHERE predicate ORDER BY expr LIMIT k`` as one filter–verification
    run (the query class the flat front-end refused outright).

    The three-valued predicate decision and the ranking bounds come from the
    same CHI pass: bound-rejected candidates leave the ranking frontier
    immediately, bound-accepted ones rank on their score bounds, and the
    *unknown* residue stays in the frontier optimistically (it might satisfy
    the predicate with its optimistic score).  One verification batch
    resolves both the predicate truth and the exact score — every CP term of
    both trees is answered from one load of the mask bytes (and one fused
    kernel row set when the scheduler drives this run).

    All pruning machinery is inherited: the base frontier is already
    predicate-aware (``p_true``/``p_false``/``p_known``), with τ drawn only
    from *definitely*-qualifying candidates, so no possibly-qualifying
    candidate is pruned on an assumption about another candidate's
    unverified predicate.  This class only re-derives the qualification
    masks from the predicate tree and verifies (predicate, score) pairs.
    """

    def __init__(self, store, pred: Pred, expr: Node, *, desc: bool = True,
                 positions: Optional[np.ndarray] = None, mask_types=None,
                 group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 verify_batch: int = 256, bounds_hook=None, backend=None):
        self.pred = pred
        super().__init__(store, expr, desc=desc, positions=positions,
                         mask_types=mask_types, group_by_image=group_by_image,
                         provided_rois=provided_rois,
                         verify_batch=verify_batch, bounds_hook=bounds_hook,
                         backend=backend, _pred_exprs=pred.value_exprs())

    def _init_qualification(self) -> None:
        # The ranking expression is "shared": a conjunct over it decides
        # from the run's full finest bounds so the pass stays memoized for
        # the ranking frontier instead of re-running per ladder rung.
        accept, reject = _decide_pred(self, self.pred,
                                      shared_exprs=(self.expr,))
        self.p_true = np.asarray(accept).copy()
        self.p_false = np.asarray(reject).copy()
        self.p_known = self.p_true | self.p_false

    def exact_values(self, batch):
        counts = self._self_counts(batch)
        if counts is not None:
            return self.fused_values(batch, counts)
        return (self.pred.exact(self.ctx, batch),
                self.ctx.exact(self.expr, batch))

    def fused_values(self, batch, counts):
        return (self.pred.exact_with_counts(self.ctx, batch, counts),
                eval_with_counts(self.ctx, self.expr, batch, counts))

    def _apply(self, batch: np.ndarray, values) -> None:
        pred_vals, score_vals = values
        pred_vals = np.asarray(pred_vals, bool)
        self.p_true[batch] = pred_vals
        self.p_false[batch] = ~pred_vals
        self.p_known[batch] = True
        self.scores[batch] = score_vals
        self.known[batch] = True


def filtered_topk_query(store, pred: Pred, expr: Node, k: int, *,
                        desc: bool = True,
                        positions: Optional[np.ndarray] = None,
                        mask_types=None, group_by_image: bool = False,
                        provided_rois: Optional[np.ndarray] = None,
                        use_index: bool = True, verify_batch: int = 256,
                        backend=None):
    """``WHERE predicate ORDER BY expr LIMIT k`` → (ids, scores, stats)."""
    if not use_index:
        ctx, ids, n_dropped = _make_context(store,
                                            list(pred.value_exprs()) + [expr],
                                            group_by_image, positions,
                                            mask_types, provided_rois,
                                            partial_rows=False)
        n = len(ids)
        stats = ExecStats(n_candidates=n, n_dropped_masks=n_dropped)
        io_before = store.io.bytes_read
        t0 = time.perf_counter()
        keep = np.nonzero(pred.exact(ctx, np.arange(n)))[0]
        exact = ctx.exact(expr, keep)
        sub = _topk_order(exact, min(k, len(keep)), desc)
        stats.n_verified = n
        stats.verify_time_s = time.perf_counter() - t0
        stats.bytes_loaded = store.io.bytes_read - io_before
        return ids[keep[sub]], exact[sub], stats

    run = FilteredTopKRun(store, pred, expr, desc=desc, positions=positions,
                          mask_types=mask_types, group_by_image=group_by_image,
                          provided_rois=provided_rois,
                          verify_batch=verify_batch, backend=backend)
    run.ensure(k)
    ids, scores = run.result()
    return ids, scores, run.stats


# ---------------------------------------------------------------------------
# Dual-mask (pair) runs — the paper's discrepancy queries as plan operators
# ---------------------------------------------------------------------------


class _PairRunMixin:
    """Shared surface of the dual-mask physical operators (DESIGN.md §9).

    All frontier machinery is inherited unchanged — a pair run is the same
    filter–verification drive over a :class:`PairEvalContext` whose
    candidates are per-image (role_a, role_b) mask pairs: bounds combine
    the two roles' CHI rows cell by cell
    (:func:`repro_torch.core.exprs.pair_cell_bounds`),
    verification answers every pair term of the plan from one fused
    dual-mask kernel pass per batch (``ExecBackend.pair_verify_counts``),
    and results refer to **image ids**.  The pruning win is squared
    relative to single-mask plans: skipping a pair skips the bytes of
    *two* masks.
    """

    @property
    def roles(self) -> tuple:
        """The (role_a, role_b) mask-type pair this run evaluates."""
        return self.ctx.roles

    def _check_pair_ctx(self) -> None:
        if not isinstance(self.ctx, PairEvalContext):
            raise ValueError(
                "pair run compiled without pair terms — use the plain "
                "FilterRun/TopKRun classes (or compile_plan) instead")


class PairFilterRun(_PairRunMixin, FilterRun):
    """``SELECT image_id WHERE <pair predicate>`` — e.g. images whose
    saliency∖attention difference count exceeds a threshold."""

    def __init__(self, store, expr_or_pred, *args, **kw):
        super().__init__(store, expr_or_pred, *args, **kw)
        self._check_pair_ctx()


class PairTopKRun(_PairRunMixin, TopKRun):
    """``SELECT image_id ORDER BY <pair expr> LIMIT k`` — e.g. the paper's
    saliency-vs-attention discrepancy ranking ``ORDER BY IOU(a, b, t, t)
    ASC LIMIT 25``."""

    def __init__(self, store, expr, **kw):
        super().__init__(store, expr, **kw)
        self._check_pair_ctx()


class PairFilteredTopKRun(_PairRunMixin, FilteredTopKRun):
    """Pair predicate + pair ranking in one run: the predicate truth and
    the exact score of one image resolve from a single load of its two
    masks."""

    def __init__(self, store, pred, expr, **kw):
        super().__init__(store, pred, expr, **kw)
        self._check_pair_ctx()


# ---------------------------------------------------------------------------
# Scalar aggregation
# ---------------------------------------------------------------------------


class ScalarAggRun(_VerifyRun):
    """Resumable SUM/AVG: bound-coincident candidates are exact for free;
    only the undecided residue verifies.  ``result()`` is the scalar."""

    def __init__(self, store, expr: Node, agg: str, *,
                 positions: Optional[np.ndarray] = None, mask_types=None,
                 group_by_image: bool = False,
                 provided_rois: Optional[np.ndarray] = None,
                 verify_batch: int = 256, bounds_hook=None, backend=None):
        agg = agg.upper()
        if agg not in ("SUM", "AVG"):
            raise ValueError(f"ScalarAggRun handles SUM/AVG, got {agg!r}")
        self.agg = agg
        self.expr = expr
        super().__init__(store, [expr], positions=positions,
                         mask_types=mask_types, group_by_image=group_by_image,
                         provided_rois=provided_rois,
                         verify_batch=verify_batch, bounds_hook=bounds_hook,
                         backend=backend)
        lb, ub = self.expr_bounds(expr)
        self.values = lb.astype(np.float64)   # astype copies; safe to mutate
        self.pending = np.nonzero(lb != ub)[0]
        self.stats.n_decided_by_bounds = self.n - len(self.pending)

    def finished(self) -> bool:
        return self.cursor >= len(self.pending)

    def exact_values(self, batch):
        counts = self._self_counts(batch)
        if counts is not None:
            return self.fused_values(batch, counts)
        return self.ctx.exact(self.expr, batch)

    def fused_values(self, batch, counts):
        return eval_with_counts(self.ctx, self.expr, batch, counts)

    def _apply(self, batch: np.ndarray, values) -> None:
        self.values[batch] = values

    def result(self) -> float:
        if self.agg == "SUM":
            return float(self.values.sum())
        return float(self.values.mean()) if self.n else float("nan")


class MinMaxAggRun(TopKRun):
    """MIN/MAX through the top-k pruning machinery (k = 1); ``result()`` is
    the scalar (NaN on an empty candidate set, matching SUM/AVG's clean
    empty-set behavior)."""

    def __init__(self, store, expr: Node, agg: str, **kw):
        agg = agg.upper()
        if agg not in ("MIN", "MAX"):
            raise ValueError(f"MinMaxAggRun handles MIN/MAX, got {agg!r}")
        self.agg = agg
        super().__init__(store, expr, desc=(agg == "MAX"), **kw)
        TopKRun.target(self, 1)

    def target(self, k: Optional[int] = None) -> int:
        return self.k  # the finality target is always 1

    def result(self) -> float:
        _, scores = TopKRun.result(self, 1)
        return float(scores[0]) if len(scores) else float("nan")


def scalar_agg(store, expr: Node, agg: str, *,
               positions: Optional[np.ndarray] = None, mask_types=None,
               provided_rois: Optional[np.ndarray] = None,
               use_index: bool = True, backend=None):
    """``SELECT SCALAR_AGG(expr)`` with agg ∈ {SUM, AVG, MIN, MAX}.

    MIN/MAX reuse the top-k pruning machinery (k=1).  SUM/AVG verify only
    bound-undecided masks.  Returns ``(value, stats)``.  An empty candidate
    set (e.g. ``mask_type IN (...)`` matching nothing) yields NaN for
    AVG/MIN/MAX and 0.0 for SUM, never an exception.
    """
    agg = agg.upper()
    common = dict(positions=positions, mask_types=mask_types,
                  provided_rois=provided_rois)
    if not use_index:
        if agg in ("MIN", "MAX"):
            _, scores, stats = topk_query(store, expr, 1,
                                          desc=(agg == "MAX"),
                                          use_index=False, **common)
            value = float(scores[0]) if len(scores) else float("nan")
            return value, stats
        ctx, ids, n_dropped = _make_context(store, [expr], False, positions,
                                            mask_types, provided_rois,
                                            partial_rows=False)
        n = len(ids)
        stats = ExecStats(n_candidates=n, n_dropped_masks=n_dropped)
        io_before = store.io.bytes_read
        exact = ctx.exact(expr, np.arange(n)) if n else np.empty(0)
        stats.n_verified = n
        stats.bytes_loaded = store.io.bytes_read - io_before
        if agg == "SUM":
            value = float(exact.sum())
        else:
            value = float(exact.mean()) if n else float("nan")
        return value, stats

    if agg in ("MIN", "MAX"):
        run = MinMaxAggRun(store, expr, agg, backend=backend, **common)
    else:
        run = ScalarAggRun(store, expr, agg, backend=backend,
                           verify_batch=max(len(store), 1), **common)
    run.ensure()
    return run.result(), run.stats
