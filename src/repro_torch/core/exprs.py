"""Query expressions over CP terms, with sound interval (bounds) semantics.

The paper lets users "use multiple CP functions and apply arithmetic
operations in queries" — e.g. Scenario 1 normalizes a CP by the ROI area and
Scenario 3 ranks by ``CP(intersect(...))/CP(union(...))`` (IoU).  This module
gives those expressions two evaluation modes:

* ``bounds``  — interval arithmetic over CHI-derived (lower, upper) bounds;
                never touches mask bytes.  Soundness: the exact value always
                lies inside the returned interval.
* ``exact``   — evaluation against loaded mask bytes (the verification path).

Two unit kinds exist:

* per-**mask** expressions (Filter/Top-K/scalar-agg) built from :class:`CP`;
* per-**group** expressions (the paper's MASK_AGG, GROUP BY image_id) built
  from :class:`AggCP` over the masks of one image — intersection / union of
  thresholded member masks, with bounds derived purely from member CP bounds:

      intersect:  ub = min_i ub_i,  lb = max(0, Σ lb_i − (n−1)·|roi|)
      union:      lb = max_i lb_i,  ub = min(|roi|, Σ ub_i)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels import ops as kops
from . import chi as chi_lib
from . import cp as cp_lib
from . import packing

_INF = np.float64(np.inf)


def _as_rois(roi, positions: np.ndarray, store_rois: Optional[np.ndarray],
             cfg) -> np.ndarray:
    """Resolve a term's ROI spec to an ``(n, 4)`` array for these rows.

    ``roi`` is ``None`` (full mask), a 4-tuple constant rectangle, or the
    string ``"provided"`` meaning per-mask ROIs supplied by the caller
    (the paper's mask-dependent ROIs, e.g. YOLO boxes keyed by image).
    """
    n = len(positions)
    if roi is None:
        return cp_lib.normalize_rois(None, n, cfg.height, cfg.width)
    if isinstance(roi, str) and roi == "provided":
        if store_rois is None:
            raise ValueError("query uses provided ROIs but none were given")
        return cp_lib.normalize_rois(store_rois[positions], n, cfg.height, cfg.width)
    return cp_lib.normalize_rois(np.asarray(roi), n, cfg.height, cfg.width)


class Node:
    """Expression tree base."""

    def __truediv__(self, other):
        return BinOp("/", self, _wrap(other))

    def __mul__(self, other):
        return BinOp("*", self, _wrap(other))

    def __add__(self, other):
        return BinOp("+", self, _wrap(other))

    def __sub__(self, other):
        return BinOp("-", self, _wrap(other))

    def cp_terms(self):
        return []


def _wrap(x):
    return x if isinstance(x, Node) else Const(float(x))


@dataclasses.dataclass(frozen=True)
class Const(Node):
    value: float

    def cp_terms(self):
        return []


@dataclasses.dataclass(frozen=True)
class CP(Node):
    """CP(mask, roi, (lv, uv)) — the paper's primitive."""

    roi: object  # None | (r0,c0,r1,c1) | "provided"
    lv: float
    uv: float

    def cp_terms(self):
        return [self]


@dataclasses.dataclass(frozen=True)
class RoiArea(Node):
    """Pixel area of the term's ROI — for normalized CPs (Scenario 1)."""

    roi: object

    def cp_terms(self):
        return []


@dataclasses.dataclass(frozen=True)
class AggCP(Node):
    """CP(MASK_AGG(mask > thresh), roi, (lv, uv)) over one image's masks.

    ``agg`` ∈ {"intersect", "union"}.  The aggregated mask is binary, so the
    counted pixels are those where the intersection/union holds; ``lv/uv``
    are implied (count of 1s) and kept for API symmetry.
    """

    agg: str
    thresh: float
    roi: object

    def cp_terms(self):
        return [self]


@dataclasses.dataclass(frozen=True)
class PairTerm(Node):
    """A per-image function of **two** mask roles (DESIGN.md §9).

    Roles are mask_types: for each image the plan pairs its first role-A
    mask with its first role-B mask, thresholds them (``> ta`` / ``> tb``)
    and counts, inside the pair's ROI, the pixels of

        ``stat="inter"`` — A∩B,   ``stat="union"`` — A∪B,
        ``stat="diff"``  — A∖B  (|B∖A| is the same term with roles swapped).

    IoU and every other pair statistic are expression trees over these
    three counts (see :func:`pair_iou`), so interval arithmetic, the
    guarded division and fused verification all come for free.  Bounds
    derive from each role's CHI tables alone (no mask bytes) — the sound
    combination rules over thresholded-count bounds (lo_X, hi_X) of a
    region of area ``|R|``:

        inter:  max(0, lo_A + lo_B − |R|) ≤ · ≤ min(hi_A, hi_B)
        union:  max(lo_A, lo_B)           ≤ · ≤ min(|R|, hi_A + hi_B)
        diff:   max(0, lo_A − hi_B)       ≤ · ≤ min(hi_A, |R| − lo_B)

    (diff = A ∩ Bᶜ with Bᶜ's count in [|R|−hi_B, |R|−lo_B]) — applied
    **per CHI cell** and summed (:func:`pair_cell_bounds`), which is
    always at least as tight as applying them to the whole ROI and is
    what makes spatial-discrepancy pruning work at all.
    """

    stat: str     # "inter" | "union" | "diff"
    role_a: int   # mask_type of role A (e.g. 1 = model saliency)
    role_b: int   # mask_type of role B (e.g. 2 = human attention)
    ta: float     # threshold for A (binary A = mask_A > ta)
    tb: float     # threshold for B
    roi: object = None   # None | (r0,c0,r1,c1) | "provided"

    def __post_init__(self):
        if self.stat not in ("inter", "union", "diff"):
            raise ValueError(f"unknown pair stat {self.stat!r}")

    def cp_terms(self):
        return [self]


def pair_iou(role_a: int, role_b: int, ta: float, tb: float,
             roi=None) -> Node:
    """``IOU(role_a, role_b, ta, tb)`` as an expression tree: the ratio of
    the pair's intersection and union counts.  Both terms share one
    (ta, tb, roi) pair spec, so verification answers them from a single
    fused kernel pass over the two masks."""
    return BinOp("/", PairTerm("inter", role_a, role_b, ta, tb, roi),
                 PairTerm("union", role_a, role_b, ta, tb, roi))


def pair_stat_bounds(stat: str, a_lb, a_ub, b_lb, b_ub, area):
    """Sound (lb, ub) for one pair stat from *aggregate* thresholded-count
    bounds over one region (see :class:`PairTerm`).  This is the area-level
    combination rule; execution uses its cell-decomposed refinement
    (:func:`pair_cell_bounds`), which applies these same formulas per CHI
    cell and is therefore always at least as tight — kept as the
    documented algebra and the property-test envelope."""
    if stat == "inter":
        return (np.maximum(0.0, a_lb + b_lb - area),
                np.minimum(a_ub, b_ub))
    if stat == "union":
        return (np.maximum(a_lb, b_lb),
                np.minimum(area, a_ub + b_ub))
    if stat == "diff":
        return (np.maximum(0.0, a_lb - b_ub),
                np.minimum(a_ub, area - b_lb))
    raise ValueError(f"unknown pair stat {stat!r}")


def _threshold_ks(cfg, thresh: float) -> tuple[int, int]:
    """CHI value-edge indices (inner, outer) for the strict ``> thresh``
    count.  ``[nextafter32(t), ∞)`` contains exactly the float32 values
    strictly above ``t``, so the resulting bounds are sound — and tight —
    for the comparison the pair kernel evaluates (no measure-zero
    unsoundness when a threshold coincides with a bin edge)."""
    lv = float(np.nextafter(np.float32(thresh), np.float32(np.inf)))
    edges = cfg.edges
    k_in = int(np.clip(np.searchsorted(edges, lv, side="left"),
                       0, cfg.num_bins))
    k_out = int(np.clip(np.searchsorted(edges, lv, side="right") - 1,
                        0, cfg.num_bins))
    return k_in, k_out


def _cell_counts(tables: np.ndarray, k: int) -> np.ndarray:
    """Per-cell counts of pixels with value ≥ edges[k], from the CHI
    prefix-sum rows: (n, G+1, G+1, NB+1) → (n, G, G) int64."""
    p = tables[..., -1].astype(np.int64) - tables[..., k].astype(np.int64)
    return p[:, 1:, 1:] - p[:, :-1, 1:] - p[:, 1:, :-1] + p[:, :-1, :-1]


def pair_cell_bounds(cfg, stat: str, lo_a, hi_a, lo_b, hi_b,
                     rois: np.ndarray):
    """Cell-decomposed sound (lb, ub) for one pair stat (DESIGN.md §9).

    ``lo_X``/``hi_X``: (n, G, G) per-cell lower/upper counts of role X's
    thresholded pixels (from :func:`_cell_counts` at the inner/outer value
    edge).  The pair stat is summed cell by cell — e.g. for the difference
    A∖B, a cell where the model is provably hot (``lo_a``) and the human
    provably cold (``hi_b``) contributes ``lo_a − hi_b`` to the lower
    bound — which captures the *spatial* disjointness discrepancy queries
    rank by; the area-level rule (:func:`pair_stat_bounds`) cannot (its
    lower bounds collapse to 0 for full-image regions).  Each cell's
    contribution applies the area-level algebra to that cell, restricted
    to its overlap with the ROI: partial-overlap cells contribute 0 to
    lower bounds and an overlap-clamped upper, so arbitrary pixel ROIs
    stay sound.  By convexity the cell sum dominates the area-level rule,
    so only this path runs in execution.
    """
    rb = np.asarray(cfg.row_bounds, np.int64)
    cb = np.asarray(cfg.col_bounds, np.int64)
    r0, c0 = rois[:, 0][:, None], rois[:, 1][:, None]
    r1, c1 = rois[:, 2][:, None], rois[:, 3][:, None]
    ov_r = np.clip(np.minimum(r1, rb[None, 1:]) -
                   np.maximum(r0, rb[None, :-1]), 0, None)     # (n, G)
    ov_c = np.clip(np.minimum(c1, cb[None, 1:]) -
                   np.maximum(c0, cb[None, :-1]), 0, None)
    full_r = (rb[None, :-1] >= r0) & (rb[None, 1:] <= r1)
    full_c = (cb[None, :-1] >= c0) & (cb[None, 1:] <= c1)
    overlap = ov_r[:, :, None] * ov_c[:, None, :]              # |cell ∩ R|
    full = full_r[:, :, None] & full_c[:, None, :]             # cell ⊆ R
    cell_area = ((rb[1:] - rb[:-1])[None, :, None] *
                 (cb[1:] - cb[:-1])[None, None, :])
    if stat == "inter":
        lb = np.where(full, np.maximum(0, lo_a + lo_b - cell_area), 0)
        ub = np.minimum(np.minimum(hi_a, hi_b), overlap)
    elif stat == "union":
        lb = np.where(full, np.maximum(lo_a, lo_b), 0)
        ub = np.minimum(overlap, hi_a + hi_b)
    elif stat == "diff":
        lb = np.where(full, np.maximum(0, lo_a - hi_b), 0)
        ub = np.where(full,
                      np.minimum(np.minimum(hi_a, overlap),
                                 cell_area - lo_b),
                      np.minimum(hi_a, overlap))
    else:
        raise ValueError(f"unknown pair stat {stat!r}")
    return (lb.sum(axis=(1, 2)).astype(np.float64),
            ub.sum(axis=(1, 2)).astype(np.float64))


def cell_counts_torch(tables: torch.Tensor, k: int) -> torch.Tensor:
    """Device mirror of :func:`_cell_counts` — the same corner-difference
    math on a CHI row tensor (n, G+1, G+1, NB+1) → (n, G, G), in int32 (a
    cell's count is at most H·W, so int32 is exact)."""
    p = (tables[..., -1] - tables[..., k]).to(torch.int32)
    return p[:, 1:, 1:] - p[:, :-1, 1:] - p[:, 1:, :-1] + p[:, :-1, :-1]


def pair_cell_bounds_torch(stat: str, lo_a, hi_a, lo_b, hi_b,
                           rois: torch.Tensor, row_bounds: torch.Tensor,
                           col_bounds: torch.Tensor):
    """Device mirror of :func:`pair_cell_bounds` — the identical per-cell
    formulas in int32 on the tensors' device, summed over the grid in int64
    and returned as float64, so the result equals the host path's bit for
    bit.  The boundary tensors come in as operands, so one code path
    serves every tier."""
    rb = row_bounds.to(torch.int32)
    cb = col_bounds.to(torch.int32)
    rois = rois.to(torch.int32)
    r0, c0 = rois[:, 0, None], rois[:, 1, None]
    r1, c1 = rois[:, 2, None], rois[:, 3, None]
    ov_r = (torch.minimum(r1, rb[None, 1:]) -
            torch.maximum(r0, rb[None, :-1])).clamp(min=0)
    ov_c = (torch.minimum(c1, cb[None, 1:]) -
            torch.maximum(c0, cb[None, :-1])).clamp(min=0)
    full_r = (rb[None, :-1] >= r0) & (rb[None, 1:] <= r1)
    full_c = (cb[None, :-1] >= c0) & (cb[None, 1:] <= c1)
    overlap = ov_r[:, :, None] * ov_c[:, None, :]
    full = full_r[:, :, None] & full_c[:, None, :]
    cell_area = ((rb[1:] - rb[:-1])[None, :, None] *
                 (cb[1:] - cb[:-1])[None, None, :])
    zero = torch.zeros((), dtype=torch.int32, device=rois.device)
    if stat == "inter":
        lb = torch.where(full, (lo_a + lo_b - cell_area).clamp(min=0), zero)
        ub = torch.minimum(torch.minimum(hi_a, hi_b), overlap)
    elif stat == "union":
        lb = torch.where(full, torch.maximum(lo_a, lo_b), zero)
        ub = torch.minimum(overlap, hi_a + hi_b)
    elif stat == "diff":
        lb = torch.where(full, (lo_a - hi_b).clamp(min=0), zero)
        ub = torch.where(full,
                         torch.minimum(torch.minimum(hi_a, overlap),
                                       cell_area - lo_b),
                         torch.minimum(hi_a, overlap))
    else:
        raise ValueError(f"unknown pair stat {stat!r}")
    return (lb.sum(dim=(1, 2), dtype=torch.int64).to(torch.float64),
            ub.sum(dim=(1, 2), dtype=torch.int64).to(torch.float64))


@dataclasses.dataclass(frozen=True)
class BinOp(Node):
    op: str
    left: Node
    right: Node

    def cp_terms(self):
        return self.left.cp_terms() + self.right.cp_terms()


# ---------------------------------------------------------------------------
# Comparison semantics (shared by predicates and the engine's filter path)
# ---------------------------------------------------------------------------

_CMP_EXACT = {
    "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
}


def cmp_exact(op: str, values, threshold):
    """Exact truth of ``values op threshold`` (vectorized)."""
    return _CMP_EXACT[op](values, threshold)


def cmp_decide(op: str, lb, ub, threshold):
    """Sound three-valued decision of ``exact op threshold`` from bounds.

    Returns ``(accept, reject)`` boolean arrays: *accept* iff the comparison
    must hold for every exact ∈ [lb, ub], *reject* iff it cannot hold;
    neither → unknown (verification required).
    """
    if op == "<":
        return ub < threshold, lb >= threshold
    if op == "<=":
        return ub <= threshold, lb > threshold
    if op == ">":
        return lb > threshold, ub <= threshold
    if op == ">=":
        return lb >= threshold, ub < threshold
    raise ValueError(f"bad comparison {op!r}")


# ---------------------------------------------------------------------------
# Boolean predicate trees (the query-plan IR's WHERE clause)
# ---------------------------------------------------------------------------


class Pred:
    """Boolean predicate tree over value expressions.

    Two evaluation modes mirror :class:`Node`'s:

    * :meth:`decide` — **three-valued** bounds evaluation.  Each subtree maps
      its children's (accept, reject) pairs to its own, so conjunctions and
      disjunctions of CP predicates still prune from CHI bounds alone:

          Cmp:  sound interval comparison (``cmp_decide``)
          And:  accept = a₁ ∧ a₂,  reject = r₁ ∨ r₂
          Or:   accept = a₁ ∨ a₂,  reject = r₁ ∧ r₂
          Not:  accept = r,        reject = a

      Soundness invariant: accept ⇒ exact-true, reject ⇒ exact-false, for
      every assignment of exact values inside the children's bounds.
    * :meth:`exact` / :meth:`exact_with_counts` — truth against loaded mask
      bytes (the verification path / the scheduler's fused-counts path).
    """

    def __and__(self, other):
        return And(self, other)

    def __or__(self, other):
        return Or(self, other)

    def __invert__(self):
        return Not(self)

    def value_exprs(self) -> list:
        """Distinct value expressions (Cmp left-hand sides) in tree order."""
        out: list = []
        for e in self._value_exprs():
            if e not in out:
                out.append(e)
        return out

    def _value_exprs(self):
        return []

    def cp_terms(self) -> list:
        return [t for e in self._value_exprs() for t in e.cp_terms()]

    def decide(self, bounds_of, ctx):
        """(accept, reject) bool arrays; ``bounds_of(expr) -> (lb, ub)``."""
        raise NotImplementedError

    def exact(self, ctx, idx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def exact_with_counts(self, ctx, idx: np.ndarray, counts: dict) -> np.ndarray:
        """Exact truth when every CP term's count is precomputed (fused)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Cmp(Pred):
    """Leaf comparison ``expr op threshold`` with op ∈ {<, <=, >, >=}."""

    expr: Node
    op: str
    threshold: float

    def __post_init__(self):
        if self.op not in _CMP_EXACT:
            raise ValueError(f"bad comparison {self.op!r}")

    def _value_exprs(self):
        return [self.expr]

    def decide(self, bounds_of, ctx):
        lb, ub = bounds_of(self.expr)
        return cmp_decide(self.op, lb, ub, self.threshold)

    def exact(self, ctx, idx):
        return cmp_exact(self.op, ctx.exact(self.expr, idx), self.threshold)

    def exact_with_counts(self, ctx, idx, counts):
        vals = eval_with_counts(ctx, self.expr, idx, counts)
        return cmp_exact(self.op, vals, self.threshold)


@dataclasses.dataclass(frozen=True)
class TypeIn(Pred):
    """``mask_type IN (...)`` as a composable leaf (never unknown)."""

    types: tuple

    def decide(self, bounds_of, ctx):
        m = self._match(ctx, None)
        return m, ~m

    def _match(self, ctx, idx):
        if not isinstance(ctx, MaskEvalContext):
            raise TypeError("mask_type IN is a per-mask predicate; it cannot "
                            "appear in a grouped (MASK_AGG) query")
        if idx is None:
            idx = np.arange(len(ctx.positions))
        types = ctx.store.meta["mask_type"][ctx.positions[idx]]
        return np.isin(types, np.asarray(self.types))

    def exact(self, ctx, idx):
        return self._match(ctx, idx)

    def exact_with_counts(self, ctx, idx, counts):
        return self._match(ctx, idx)


@dataclasses.dataclass(frozen=True)
class And(Pred):
    left: Pred
    right: Pred

    def _value_exprs(self):
        return self.left._value_exprs() + self.right._value_exprs()

    def decide(self, bounds_of, ctx):
        la, lr = self.left.decide(bounds_of, ctx)
        ra, rr = self.right.decide(bounds_of, ctx)
        return la & ra, lr | rr

    def exact(self, ctx, idx):
        return self.left.exact(ctx, idx) & self.right.exact(ctx, idx)

    def exact_with_counts(self, ctx, idx, counts):
        return (self.left.exact_with_counts(ctx, idx, counts) &
                self.right.exact_with_counts(ctx, idx, counts))


@dataclasses.dataclass(frozen=True)
class Or(Pred):
    left: Pred
    right: Pred

    def _value_exprs(self):
        return self.left._value_exprs() + self.right._value_exprs()

    def decide(self, bounds_of, ctx):
        la, lr = self.left.decide(bounds_of, ctx)
        ra, rr = self.right.decide(bounds_of, ctx)
        return la | ra, lr & rr

    def exact(self, ctx, idx):
        return self.left.exact(ctx, idx) | self.right.exact(ctx, idx)

    def exact_with_counts(self, ctx, idx, counts):
        return (self.left.exact_with_counts(ctx, idx, counts) |
                self.right.exact_with_counts(ctx, idx, counts))


@dataclasses.dataclass(frozen=True)
class Not(Pred):
    child: Pred

    def _value_exprs(self):
        return self.child._value_exprs()

    def decide(self, bounds_of, ctx):
        a, r = self.child.decide(bounds_of, ctx)
        return r, a

    def exact(self, ctx, idx):
        return ~self.child.exact(ctx, idx)

    def exact_with_counts(self, ctx, idx, counts):
        return ~self.child.exact_with_counts(ctx, idx, counts)


def is_group_pred(pred: Pred) -> bool:
    return any(isinstance(t, AggCP) for t in pred.cp_terms())


# ---------------------------------------------------------------------------
# Interval arithmetic
# ---------------------------------------------------------------------------


def _interval_binop(op, llb, lub, rlb, rub):
    if op == "+":
        return llb + rlb, lub + rub
    if op == "-":
        return llb - rub, lub - rlb
    if op == "*":
        cands = np.stack([llb * rlb, llb * rub, lub * rlb, lub * rub])
        return cands.min(0), cands.max(0)
    if op == "/":
        # CP counts are >= 0; we only support non-negative denominators
        # (true for all paper queries).  den lb == 0 → upper bound +inf.
        with np.errstate(divide="ignore", invalid="ignore"):
            lb = np.where(rub > 0, llb / rub, 0.0)
            ub = np.where(rlb > 0, lub / rlb, np.where(lub > 0, _INF, 0.0))
        return lb, ub
    raise ValueError(f"unknown op {op}")


def _exact_binop(op: str, l, r):
    """Exact arithmetic over evaluated subtrees — one implementation of the
    guarded division (0/0 → 0) for every evaluation context."""
    if op == "/":
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(r != 0, l / np.where(r == 0, 1, r), 0.0)
    return {"+": np.add, "-": np.subtract, "*": np.multiply}[op](l, r)


# ---------------------------------------------------------------------------
# Per-mask evaluation
# ---------------------------------------------------------------------------


class MaskEvalContext:
    """Binds an expression to a store partition + candidate row positions.

    ``partial_rows``: verification for single-CP expressions loads only each
    mask's ROI row-span (store.load_rows) — a beyond-paper I/O optimization;
    disabled automatically when the expression needs full masks or the
    store's cross-query cache is active (full masks are what's shared).
    """

    def __init__(self, store, positions: np.ndarray,
                 provided_rois: Optional[np.ndarray] = None,
                 partial_rows: bool = True):
        self.store = store
        self.cfg = store.cfg
        self.positions = np.asarray(positions, dtype=np.int64)
        self.provided_rois = provided_rois
        self.partial_rows = partial_rows
        # Optional ExecBackend (core/backend.py) routing physical leaves;
        # None → the host paths below (set by engine._make_context).
        self.backend = None
        # Pyramid bound tier (DESIGN.md §13): None → the finest grid.  Set
        # on ladder subcontexts by the optimizer so every backend's CP-leaf
        # primitive reads the matching coarse CHI tier.
        self.tier: Optional[int] = None
        # Device the host path's verification kernels run on: the store's.
        self.device = getattr(store, "device", torch.device("cpu"))
        self._loaded: Optional[np.ndarray] = None  # aligned with positions
        # Loaded rows live in one buffer grown by doubling (capped at the
        # candidate count), so a run that loads in many rounds copies each
        # row O(1) times amortized; _loaded maps a candidate to its row.
        self._buf: Optional[np.ndarray] = None
        self._rows_used = 0

    def resolve_rois(self, roi, store_positions: np.ndarray) -> np.ndarray:
        """Public ROI resolution for arbitrary store row positions — used by
        the service scheduler to build fused cp_count_multi descriptor rows."""
        return _as_rois(roi, store_positions, self.provided_rois, self.cfg)

    # bytes ----------------------------------------------------------------
    def masks_for(self, idx: np.ndarray) -> np.ndarray:
        """Load (and cache) mask bytes for candidate indices ``idx``."""
        if self._loaded is None:
            self._loaded = np.full((len(self.positions),), -1, dtype=np.int64)
        missing = idx[self._loaded[idx] < 0]
        if len(missing):
            new = self.store.load(self.positions[missing])
            end = self._rows_used + len(new)
            if self._buf is None or end > len(self._buf):
                old = 0 if self._buf is None else len(self._buf)
                cap = max(end, min(2 * old, len(self.positions)))
                grown = np.empty((cap,) + new.shape[1:], new.dtype)
                if self._buf is not None:
                    grown[:self._rows_used] = self._buf[:self._rows_used]
                self._buf = grown
            self._buf[self._rows_used:end] = new
            self._loaded[missing] = self._rows_used + np.arange(len(missing))
            self._rows_used = end
        return self._buf[self._loaded[idx]]

    def _can_partial(self, node) -> bool:
        return (self.partial_rows and self._loaded is None and
                not self.store.cache_enabled and
                len(node.cp_terms()) <= 1)

    # bounds -----------------------------------------------------------------
    def bounds(self, node: Node, cp_leaf=None):
        """(lb, ub) float64 arrays over all candidate positions.

        ``cp_leaf(ctx, cp_node) -> (lb, ub)`` optionally overrides the
        CP-leaf bounds primitive (an execution backend's device/mesh CHI
        pass); the interval arithmetic over the tree stays shared, so every
        backend prunes with identical semantics."""
        n = len(self.positions)
        if isinstance(node, Const):
            v = np.full(n, node.value)
            return v.copy(), v.copy()
        if isinstance(node, RoiArea):
            rois = _as_rois(node.roi, self.positions, self.provided_rois, self.cfg)
            a = cp_lib.roi_area(rois).astype(np.float64)
            return a.copy(), a.copy()
        if isinstance(node, CP):
            if cp_leaf is not None:
                return cp_leaf(self, node)
            return self._chi_cp_bounds(node)
        if isinstance(node, BinOp):
            llb, lub = self.bounds(node.left, cp_leaf)
            rlb, rub = self.bounds(node.right, cp_leaf)
            return _interval_binop(node.op, llb, lub, rlb, rub)
        raise TypeError(f"node {node} not valid in a per-mask expression")

    def _chi_cp_bounds(self, node: CP):
        """Host CP-leaf bounds: CHI gather over the store's index at this
        context's bound tier (the finest grid unless a refinement-ladder
        subcontext pinned a coarser one)."""
        rois = _as_rois(node.roi, self.positions, self.provided_rois, self.cfg)
        g = self.tier
        if g is None or g == self.cfg.grid:
            cfg, table = self.cfg, self.store.chi_table
        else:
            cfg, table = self.cfg.for_grid(g), self.store.chi_tier_table(g)
        table = table[torch.as_tensor(self.positions).to(table.device)]
        lb, ub = chi_lib.chi_bounds(table, cfg, rois, node.lv, node.uv)
        return (lb.cpu().numpy().astype(np.float64),
                ub.cpu().numpy().astype(np.float64))

    # exact ------------------------------------------------------------------
    def exact(self, node: Node, idx: np.ndarray) -> np.ndarray:
        """Exact value for candidate indices ``idx`` (loads mask bytes)."""
        self._use_partial = self._can_partial(node)
        return self._exact_node(node, idx)

    def _cp_partial(self, node: CP, idx: np.ndarray) -> np.ndarray:
        """Exact CP reading only each mask's ROI row span from disk."""
        rois = _as_rois(node.roi, self.positions[idx], self.provided_rois,
                        self.cfg)
        spans = rois[:, [0, 2]]
        buf, heights = self.store.load_rows(self.positions[idx], spans)
        local = np.stack([np.zeros(len(idx), np.int64), rois[:, 1],
                          heights.astype(np.int64), rois[:, 3]], axis=1)
        # packed rows are uint32 words; column coords are unchanged (the
        # packed layout is per-row, so a row span packs identically)
        counts = self._cp_kernel_of()(
            self._on_device(buf), self._on_device(local.astype(np.int32)),
            node.lv, min(node.uv, 3.4e38))
        return counts.cpu().numpy().astype(np.float64)

    def _cp_kernel_of(self):
        """The CP verification kernel for this store's tier: ``cp_count``
        (lv/uv rounded to the mask dtype) or ``cp_count_packed`` (lv/uv
        rounded to float32, then range flags)."""
        if getattr(self.store, "packed", False):
            return kops.cp_count_packed
        return kops.cp_count

    def _on_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host batch moved to the store's device for a kernel launch
        (packed words as their int32 bit view)."""
        return torch.from_numpy(packing.torch_bits(arr)).to(self.device)

    def _eval_tree(self, node: Node, idx: np.ndarray, cp_eval) -> np.ndarray:
        """Shared exact-evaluation walker.  CP leaves delegate to ``cp_eval``
        (loading + kernel here; precomputed fused counts in the scheduler),
        so both paths share one set of expression semantics — notably the
        guarded division."""
        if isinstance(node, Const):
            return np.full(len(idx), node.value)
        if isinstance(node, RoiArea):
            rois = _as_rois(node.roi, self.positions[idx], self.provided_rois,
                            self.cfg)
            return cp_lib.roi_area(rois).astype(np.float64)
        if isinstance(node, CP):
            return cp_eval(node, idx)
        if isinstance(node, BinOp):
            return _exact_binop(node.op,
                                self._eval_tree(node.left, idx, cp_eval),
                                self._eval_tree(node.right, idx, cp_eval))
        raise TypeError(f"node {node} not valid in a per-mask expression")

    def _cp_exact(self, node: CP, idx: np.ndarray) -> np.ndarray:
        if self._use_partial:
            return self._cp_partial(node, idx)
        masks = self.masks_for(idx)
        rois = _as_rois(node.roi, self.positions[idx], self.provided_rois,
                        self.cfg)
        # verification hot path → the CUDA kernel on the card, its plain
        # torch version on the CPU
        counts = self._cp_kernel_of()(
            self._on_device(masks), self._on_device(rois), node.lv,
            min(node.uv, 3.4e38))
        return counts.cpu().numpy().astype(np.float64)

    def _exact_node(self, node: Node, idx: np.ndarray) -> np.ndarray:
        return self._eval_tree(node, idx, self._cp_exact)


def eval_with_counts(ctx: "MaskEvalContext", node: Node, idx: np.ndarray,
                     counts: dict) -> np.ndarray:
    """Exact per-mask expression value when every CP term's count was already
    computed by a fused multi-query kernel pass (the service scheduler's
    ``cp_count_multi`` route).  ``counts`` maps CP nodes (hashable frozen
    dataclasses) to ``(len(idx),)`` count arrays; everything else runs
    through the same walker as self-verification."""
    return ctx._eval_tree(node, idx,
                          lambda n, i: np.asarray(counts[n], np.float64))


def tier_context(ctx: "MaskEvalContext", idx: np.ndarray,
                 tier: Optional[int]) -> "MaskEvalContext":
    """A shallow subcontext over candidate indices ``idx`` of ``ctx`` with
    the bound tier pinned — what the refinement ladder hands each rung's
    bounds pass.  ``provided_rois`` stays whole-store-indexed (ROIs resolve
    by store position), the backend rides along, and ``tier=None`` means
    the finest grid, so a final rung is bit-identical to the classic path."""
    sub = MaskEvalContext(ctx.store, ctx.positions[np.asarray(idx)],
                          ctx.provided_rois, partial_rows=ctx.partial_rows)
    sub.backend = ctx.backend
    sub.tier = tier
    return sub


# ---------------------------------------------------------------------------
# Per-group (MASK_AGG) evaluation
# ---------------------------------------------------------------------------


class GroupEvalContext:
    """Binds an AggCP expression to image groups.

    ``group_positions``: (n_groups, group_size) row positions — one image's
    masks per row (the paper's ``GROUP BY image_id`` with
    ``mask_type IN (...)``).
    """

    def __init__(self, store, group_positions: np.ndarray,
                 image_ids: np.ndarray,
                 provided_rois: Optional[np.ndarray] = None):
        self.store = store
        self.cfg = store.cfg
        self.groups = np.asarray(group_positions, dtype=np.int64)
        self.image_ids = np.asarray(image_ids)
        self.provided_rois = provided_rois
        self._ctx = MaskEvalContext(store, self.groups.reshape(-1), provided_rois)
        # Optional ExecBackend routing MASK_AGG verification (None → host).
        self.backend = None

    def resolve_group_rois(self, roi, gidx: np.ndarray) -> np.ndarray:
        """Per-group ROI resolution (one ROI per image group — members
        share it), for backends building fused mask_agg kernel rows."""
        return _as_rois(roi, self.groups[np.asarray(gidx), 0],
                        self.provided_rois, self.cfg)

    def _member_bounds(self, node: AggCP, cp_leaf=None):
        """Per-member CP bounds for the thresholded mask (value > thresh)."""
        member = CP(node.roi, node.thresh, float("inf"))
        lb, ub = self._ctx.bounds(member, cp_leaf)
        g, s = self.groups.shape
        return lb.reshape(g, s), ub.reshape(g, s)

    def _areas(self, node: AggCP):
        rois = _as_rois(node.roi, self.groups[:, 0], self.provided_rois, self.cfg)
        return cp_lib.roi_area(rois).astype(np.float64)

    def bounds(self, node: Node, cp_leaf=None):
        if isinstance(node, Const):
            v = np.full(len(self.groups), node.value)
            return v.copy(), v.copy()
        if isinstance(node, AggCP):
            mlb, mub = self._member_bounds(node, cp_leaf)
            area = self._areas(node)
            n = self.groups.shape[1]
            if node.agg == "intersect":
                ub = mub.min(axis=1)
                lb = np.maximum(0.0, mlb.sum(axis=1) - (n - 1) * area)
            elif node.agg == "union":
                lb = mlb.max(axis=1)
                ub = np.minimum(area, mub.sum(axis=1))
            else:
                raise ValueError(f"unknown agg {node.agg}")
            return lb.astype(np.float64), ub.astype(np.float64)
        if isinstance(node, BinOp):
            llb, lub = self.bounds(node.left, cp_leaf)
            rlb, rub = self.bounds(node.right, cp_leaf)
            return _interval_binop(node.op, llb, lub, rlb, rub)
        raise TypeError(f"node {node} not valid in a group expression")

    def exact(self, node: Node, gidx: np.ndarray) -> np.ndarray:
        if isinstance(node, Const):
            return np.full(len(gidx), node.value)
        if isinstance(node, AggCP):
            backend = self.backend
            if backend is None:
                from .backend import host_backend
                backend = host_backend()
            return backend.mask_agg_counts(self, node, gidx)
        if isinstance(node, BinOp):
            return _exact_binop(node.op, self.exact(node.left, gidx),
                                self.exact(node.right, gidx))
        raise TypeError(f"node {node} not valid in a group expression")


def is_group_expr(node: Node) -> bool:
    return any(isinstance(t, AggCP) for t in node.cp_terms())


# ---------------------------------------------------------------------------
# Per-pair (dual-mask) evaluation
# ---------------------------------------------------------------------------


class PairEvalContext:
    """Binds pair expressions to per-image (role_a, role_b) mask rows.

    ``pos_a``/``pos_b`` are aligned ``(n,)`` store row positions — image i's
    role-A and role-B masks.  The pair's ROI resolves from the **role-A
    row** (``"provided"`` per-mask boxes, a constant rectangle, or the full
    mask) and applies to both roles, so intersection/union/difference are
    counted over one region per image.

    Pair bounds combine both roles' CHI rows cell by cell: the host path
    gathers the rows and runs :func:`pair_cell_bounds` in numpy; the device
    backend runs the same cell math on its resident CHI
    (:func:`pair_cell_bounds_torch`).  Verification answers every pair term
    of a batch from one dual-mask kernel pass per distinct
    ``(ta, tb, roi)`` spec (``ExecBackend.pair_verify_counts``).
    """

    def __init__(self, store, pos_a: np.ndarray, pos_b: np.ndarray,
                 image_ids: np.ndarray, roles: tuple,
                 provided_rois: Optional[np.ndarray] = None):
        self.store = store
        self.cfg = store.cfg
        self.pos_a = np.asarray(pos_a, dtype=np.int64)
        self.pos_b = np.asarray(pos_b, dtype=np.int64)
        self.image_ids = np.asarray(image_ids)
        self.roles = tuple(roles)
        self.provided_rois = provided_rois
        # Optional ExecBackend routing pair verification (None → host).
        self.backend = None
        self._cells_memo: dict = {}    # (role, thresh) → (lo, hi) cells

    def resolve_pair_rois(self, roi, pos_a_rows: np.ndarray) -> np.ndarray:
        """Per-pair ROI resolution at explicit role-A store rows — used by
        the service scheduler to build fused pair-pass descriptor rows."""
        return _as_rois(roi, pos_a_rows, self.provided_rois, self.cfg)

    def pair_rois(self, roi, idx: Optional[np.ndarray] = None) -> np.ndarray:
        pos = self.pos_a if idx is None else self.pos_a[np.asarray(idx)]
        return _as_rois(roi, pos, self.provided_rois, self.cfg)

    def _role_tables(self, which: str) -> np.ndarray:
        """One role's CHI rows as host numpy.  Deliberately *not* memoized:
        sessions hold their run (and thus this context) alive across
        pages, and only the much smaller per-cell counts are needed after
        the bounds pass — retaining full (n, G+1, G+1, NB+1) row copies
        per role would multiply the store's CHI footprint per open
        session."""
        pos = self.pos_a if which == "a" else self.pos_b
        store = self.store
        if hasattr(store, "chi_host"):
            return store.chi_host(pos)
        return np.asarray(store.chi_table)[pos]

    def _role_cells(self, which: str, thresh: float):
        """(lo, hi) per-cell thresholded counts for one role, memoized per
        (role, threshold) — IoU's inter and union terms share them."""
        key = (which, float(thresh))
        if key not in self._cells_memo:
            k_in, k_out = _threshold_ks(self.cfg, thresh)
            tables = self._role_tables(which)
            self._cells_memo[key] = (_cell_counts(tables, k_in),
                                     _cell_counts(tables, k_out))
        return self._cells_memo[key]

    def bounds(self, node: Node, cp_leaf=None, pair_leaf=None):
        """(lb, ub) float64 over all candidate pairs.  ``cp_leaf`` is part
        of the shared context signature but unused.  ``pair_leaf(pctx,
        term) -> (lb, ub)`` optionally overrides the PairTerm cell-combine
        primitive — the device backend runs the same cell math over its
        resident CHI (:func:`pair_cell_bounds_torch`), so the pair filter
        phase leaves the host while pruning stays bit-identical; the host
        path below gathers both roles' CHI rows and combines them cell by
        cell in numpy."""
        n = len(self.pos_a)
        if isinstance(node, Const):
            v = np.full(n, node.value)
            return v.copy(), v.copy()
        if isinstance(node, RoiArea):
            a = cp_lib.roi_area(self.pair_rois(node.roi)).astype(np.float64)
            return a.copy(), a.copy()
        if isinstance(node, PairTerm):
            if pair_leaf is not None:
                return pair_leaf(self, node)
            lo_a, hi_a = self._role_cells("a", node.ta)
            lo_b, hi_b = self._role_cells("b", node.tb)
            return pair_cell_bounds(self.cfg, node.stat, lo_a, hi_a,
                                    lo_b, hi_b, self.pair_rois(node.roi))
        if isinstance(node, BinOp):
            llb, lub = self.bounds(node.left, cp_leaf, pair_leaf)
            rlb, rub = self.bounds(node.right, cp_leaf, pair_leaf)
            return _interval_binop(node.op, llb, lub, rlb, rub)
        raise TypeError(f"node {node} not valid in a pair expression")

    def _eval_tree(self, node: Node, idx: np.ndarray, leaf_eval) -> np.ndarray:
        """Shared exact-evaluation walker (the pair analogue of
        :meth:`MaskEvalContext._eval_tree`): PairTerm leaves delegate to
        ``leaf_eval`` — precomputed counts when the scheduler fuses, a
        backend pair pass in self-verification."""
        if isinstance(node, Const):
            return np.full(len(idx), node.value)
        if isinstance(node, RoiArea):
            return cp_lib.roi_area(self.pair_rois(node.roi, idx)).astype(
                np.float64)
        if isinstance(node, PairTerm):
            return leaf_eval(node, idx)
        if isinstance(node, BinOp):
            return _exact_binop(node.op,
                                self._eval_tree(node.left, idx, leaf_eval),
                                self._eval_tree(node.right, idx, leaf_eval))
        raise TypeError(f"node {node} not valid in a pair expression")

    def exact(self, node: Node, idx: np.ndarray) -> np.ndarray:
        """Exact value for candidate indices ``idx`` — every distinct pair
        spec in the node is answered by one fused dual-mask kernel pass."""
        idx = np.asarray(idx)
        if len(idx) == 0:
            return np.empty(0, np.float64)
        terms = {t for t in node.cp_terms() if isinstance(t, PairTerm)}
        backend = self.backend
        if backend is None:
            from .backend import host_backend
            backend = host_backend()
        counts = backend.pair_verify_counts(self, idx, terms)
        return self._eval_tree(node, idx, lambda t, i: counts[t])


def is_pair_expr(node: Node) -> bool:
    return any(isinstance(t, PairTerm) for t in node.cp_terms())


def pair_roles_of(exprs) -> Optional[tuple]:
    """The single (role_a, role_b) mask-type pair the expressions use, or
    ``None`` when they contain no pair terms.  One plan evaluates against
    one role pairing; mixing pairings raises."""
    roles = {(t.role_a, t.role_b) for e in exprs for t in e.cp_terms()
             if isinstance(t, PairTerm)}
    if not roles:
        return None
    if len(roles) > 1:
        raise ValueError("all pair terms in one plan must share a single "
                         f"(role_a, role_b) mask-type pair, got "
                         f"{sorted(roles)}")
    return roles.pop()
