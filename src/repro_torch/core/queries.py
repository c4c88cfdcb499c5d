"""SQL-ish query front-end for MaskSearch (the demo GUI's "Query Command").

Supports the paper's textual query classes verbatim, e.g.::

    SELECT mask_id FROM MasksDatabaseView
    WHERE CP(mask, roi, (0.8, 1.0)) < 5000;

    SELECT mask_id FROM MasksDatabaseView
    ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 25;

    SELECT image_id,
           CP(intersect(mask > 0.8), roi, (0.5, 2.0))
         / CP(union(mask > 0.8), roi, (0.5, 2.0)) AS iou
    FROM MasksDatabaseView WHERE mask_type IN (1, 2)
    GROUP BY image_id ORDER BY iou ASC LIMIT 25;

    SELECT SCALAR_AGG(AVG, CP(mask, roi, (0.9, 1.0))) FROM MasksDatabaseView;

plus arithmetic over CP terms (including unary minus and scientific-notation
literals), ``AREA(roi)`` for normalized counts (Scenario 1), and **composable
WHERE clauses**: comparisons combine with ``AND`` / ``OR`` / ``NOT`` and
parentheses, and a predicate composes with ``ORDER BY … LIMIT`` — the
refinement shapes the demo GUI stacks up, e.g.::

    SELECT mask_id FROM MasksDatabaseView
    WHERE CP(mask, roi, (0.8, 1.0)) > 500
      AND NOT CP(mask, full_img, (0.2, 0.6)) < 100
    ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 25;

plus **dual-mask (pair) queries** — the paper's saliency-vs-attention
discrepancy scenarios as first-class terms over per-image mask pairs::

    SELECT image_id FROM MasksDatabaseView
    ORDER BY IOU(saliency, attention, 0.6, 0.6) ASC LIMIT 25;

    SELECT image_id FROM MasksDatabaseView
    WHERE PAIR_DIFF(saliency, attention, 0.6, 0.6) > 1000
    ORDER BY PAIR_INTER(saliency, attention, 0.6, 0.6, roi) ASC LIMIT 25;

``roi`` refers to caller-provided per-mask rectangles (e.g. YOLO boxes);
``full_img`` is the whole mask; a literal ``(r0, c0, r1, c1)`` rectangle is
also accepted.  The parser builds expression trees from ``core.exprs`` and a
:class:`~repro_torch.core.plan.LogicalPlan` executed through ``core.plan``;
:class:`Query` remains as a thin compatibility shim over the plan IR.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from ..obs import trace as _trace
from . import plan as plan_lib
from .exprs import (AggCP, And, BinOp, Cmp, Const, CP, Node, Not, Or,
                    PairTerm, Pred, RoiArea, TypeIn, pair_iou)
from .plan import LogicalPlan

# Demo role-name convention (scenario 3/6 and the synthetic generators):
# mask_type 1 = model saliency, mask_type 2 = human attention.  The pair
# grammar accepts these names or integer mask_types directly.
PAIR_ROLES = {"saliency": 1, "attention": 2}

_PAIR_FNS = {"PAIR_INTER": "inter", "PAIR_UNION": "union",
             "PAIR_DIFF": "diff"}

_TOKEN_RE = re.compile(r"""
      (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?|inf)
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op>[(),+\-*/<>=;]|<=|>=)
""", re.VERBOSE)

_CMP_OPS = ("<", "<=", ">", ">=")
_ARITH_OPS = ("+", "-", "*", "/")


def _tokenize(text: str):
    tokens = []
    i = 0
    text = text.strip()
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        if text[i:i + 2] in ("<=", ">="):
            tokens.append(text[i:i + 2])
            i += 2
            continue
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise SyntaxError(f"bad token at ...{text[i:i+20]!r}")
        tokens.append(m.group(0))
        i = m.end()
    return tokens


@dataclasses.dataclass
class Query:
    """A parsed query — a compatibility view over :class:`LogicalPlan`.

    The legacy flat fields (``kind``/``expr``/``op``/``threshold``/…) are
    kept for existing callers; ``plan`` is the composable IR that actually
    executes.  New code should use :func:`parse_plan` +
    :func:`repro_torch.core.plan.run_plan` directly.
    """

    kind: str                      # "filter" | "topk" | "filtered_topk"
    select: str                    # "mask_id" | "image_id"   | "scalar_agg"
    expr: Optional[Node] = None
    op: Optional[str] = None
    threshold: Optional[float] = None
    k: Optional[int] = None
    desc: bool = True
    agg: Optional[str] = None
    mask_types: Optional[tuple] = None
    group_by_image: bool = False
    predicate: Optional[Pred] = None
    plan: Optional[LogicalPlan] = dataclasses.field(default=None, repr=False)
    # "plan" | "analyze" when the SQL carried an EXPLAIN [ANALYZE] prefix.
    # Deliberately outside _snapshot(): toggling it never invalidates the
    # compiled plan.
    explain: Optional[str] = None

    def __post_init__(self):
        if self.plan is None:
            self.plan = self._derive_plan()
        self._flat_sig = self._snapshot()

    def _snapshot(self):
        return (self.kind, self.select, self.expr, self.op, self.threshold,
                self.k, self.desc, self.agg, self.mask_types,
                self.group_by_image, self.predicate)

    def _derive_plan(self) -> LogicalPlan:
        """Rebuild the IR from legacy fields (hand-constructed Queries)."""
        pred = self.predicate
        if pred is None and self.op is not None and self.kind == "filter":
            pred = Cmp(self.expr, self.op, self.threshold)
        if self.kind == "scalar_agg":
            return LogicalPlan(select="mask_id", agg=self.agg,
                               agg_expr=self.expr,
                               mask_types=self.mask_types,
                               group_by_image=False)
        order = self.expr if self.kind in ("topk", "filtered_topk") else None
        return LogicalPlan(select=self.select, predicate=pred,
                           mask_types=self.mask_types, order_by=order,
                           k=self.k, desc=self.desc,
                           group_by_image=self.group_by_image)

    def sync_plan(self) -> LogicalPlan:
        """The executable plan, re-derived if the legacy flat fields were
        mutated since it was built.  The pre-redesign Query read its flat
        fields at call time, so parse-then-tweak callers (``q.threshold =
        …; q.run(…)``) must see their mutations; mutated comparison fields
        win over a predicate derived from the stale ones.  Every execution
        path (``run`` and the service) goes through here."""
        if self._snapshot() != self._flat_sig:
            old_predicate = self._flat_sig[-1]
            if (self.kind == "filter" and self.op is not None and
                    self.predicate == old_predicate):
                self.predicate = Cmp(self.expr, self.op, self.threshold)
            self.plan = self._derive_plan()
            self._flat_sig = self._snapshot()
        return self.plan

    def run(self, store, *, provided_rois=None, use_index: bool = True,
            **kw):
        """Execute against a MaskStore.  Result shapes are unchanged from
        the flat front-end: filter → ``(ids, stats)``, rankings →
        ``((ids, scores), stats)``, scalar agg → ``(value, stats)``.

        A query parsed from ``EXPLAIN <sql>`` returns the logical operator
        tree (not executed); ``EXPLAIN ANALYZE <sql>`` executes under a
        forced-on tracer and returns the annotated report dict (see
        :mod:`repro_torch.obs.explain`)."""
        if self.explain is not None:
            from ..obs import explain as explain_mod
            if self.explain == "plan":
                return explain_mod.explain_plan(self.sync_plan())
            return explain_mod.explain_analyze(
                store, self.sync_plan(), provided_rois=provided_rois, **kw)
        return plan_lib.run_plan(store, self.sync_plan(),
                                 provided_rois=provided_rois,
                                 use_index=use_index, **kw)


def _legacy_query(plan: LogicalPlan, aliases=None) -> Query:
    """Flatten a plan into the compat record (shared fields mirrored)."""
    kind = plan.kind
    expr = None
    op = threshold = None
    if kind in ("topk", "filtered_topk"):
        expr = plan.order_by
    elif kind == "scalar_agg":
        expr = plan.agg_expr
    elif isinstance(plan.predicate, Cmp):
        expr = plan.predicate.expr
        op = plan.predicate.op
        threshold = plan.predicate.threshold
    q = Query(kind=kind, select=plan.select, expr=expr, op=op,
              threshold=threshold, k=plan.k, desc=plan.desc, agg=plan.agg,
              mask_types=plan.mask_types, group_by_image=plan.group_by_image,
              predicate=plan.predicate, plan=plan)
    q._aliases = aliases or {}
    return q


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    # -- token helpers ----------------------------------------------------
    def peek(self, off: int = 0):
        j = self.i + off
        return self.toks[j] if j < len(self.toks) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of query")
        self.i += 1
        return tok

    def expect(self, want: str):
        tok = self.next()
        if tok.upper() != want.upper():
            raise SyntaxError(f"expected {want!r}, got {tok!r}")
        return tok

    def accept(self, want: str) -> bool:
        if self.peek() is not None and self.peek().upper() == want.upper():
            self.i += 1
            return True
        return False

    def number(self) -> float:
        tok = self.next()
        sign = 1.0
        if tok == "-":
            sign = -1.0
            tok = self.next()
        if tok == "inf":
            return sign * float("inf")
        try:
            return sign * float(tok)
        except ValueError as e:
            raise SyntaxError(f"expected number, got {tok!r}") from e

    # -- grammar -----------------------------------------------------------
    def parse(self) -> Query:
        self.expect("SELECT")
        select = "mask_id"
        agg = None
        agg_expr = None
        aliases = {}
        if (self.peek() or "").upper() == "SCALAR_AGG":
            self.next()
            self.expect("(")
            agg = self.next().upper()
            self.expect(",")
            agg_expr = self.expr()
            self.expect(")")
        else:
            select = self.next()
            if select not in ("mask_id", "image_id"):
                raise SyntaxError(
                    f"can only SELECT mask_id/image_id, got {select}")
            while self.accept(","):
                e = self.expr()
                self.expect("AS")
                aliases[self.next()] = e
        self.expect("FROM")
        self.next()  # view name, ignored

        mask_types = None
        predicate = None
        if self.accept("WHERE"):
            mask_types, predicate = plan_lib.simplify_predicate(
                self._pred_or())
        group_by_image = False
        if self.accept("GROUP"):
            self.expect("BY")
            self.expect("image_id")
            group_by_image = True
        order_by = None
        k = None
        desc = True
        if self.accept("ORDER"):
            self.expect("BY")
            nxt = self.peek()
            if nxt in aliases:
                self.next()
                order_by = aliases[nxt]
            else:
                order_by = self.expr()
            if self.accept("ASC"):
                desc = False
            else:
                self.accept("DESC")
            self.expect("LIMIT")
            k = int(self.number())
        self.accept(";")
        if self.peek() is not None:
            raise SyntaxError(f"trailing tokens at {self.peek()!r}")

        if agg is not None:
            if predicate is not None:
                raise SyntaxError(
                    "SCALAR_AGG supports only mask_type IN (...) in WHERE")
            if order_by is not None:
                raise SyntaxError("SCALAR_AGG cannot be ordered")
            plan = LogicalPlan(select="mask_id", agg=agg, agg_expr=agg_expr,
                               mask_types=mask_types)
        else:
            if select == "image_id":
                group_by_image = True
            if order_by is None and predicate is None:
                if mask_types is not None:
                    # pure source filter: every candidate of the type(s)
                    predicate = TypeIn(mask_types)
                else:
                    raise SyntaxError(
                        "filter query needs a predicate or ORDER BY")
            plan = LogicalPlan(select=select, predicate=predicate,
                               mask_types=mask_types, order_by=order_by,
                               k=k, desc=desc, group_by_image=group_by_image)
        try:
            plan.validate()
        except ValueError as e:
            raise SyntaxError(str(e)) from e
        return _legacy_query(plan, aliases)

    # predicate grammar:  or := and (OR and)* ;  and := unary (AND unary)* ;
    # unary := NOT unary | atom ;  atom := '(' or ')' | mask_type IN (...)
    #                                    | expr cmp_op number
    def _pred_or(self) -> Pred:
        node = self._pred_and()
        while self.accept("OR"):
            node = Or(node, self._pred_and())
        return node

    def _pred_and(self) -> Pred:
        node = self._pred_unary()
        while self.accept("AND"):
            node = And(node, self._pred_unary())
        return node

    def _pred_unary(self) -> Pred:
        if self.accept("NOT"):
            return Not(self._pred_unary())
        return self._pred_atom()

    def _pred_atom(self) -> Pred:
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of query (expected predicate)")
        if tok == "(":
            # Backtracking disambiguation: '(' may open a parenthesized
            # predicate or a parenthesized arithmetic expression.  Try the
            # predicate read; if it fails — or the closing paren is followed
            # by an operator, meaning the parens belonged to arithmetic —
            # rewind and parse a comparison instead.
            save = self.i
            try:
                self.next()
                node = self._pred_or()
                self.expect(")")
            except SyntaxError:
                self.i = save
            else:
                if (self.peek() or "") not in _CMP_OPS + _ARITH_OPS:
                    return node
                self.i = save
        if (tok or "").lower() == "mask_type":
            self.next()
            self.expect("IN")
            self.expect("(")
            types = [int(self.number())]
            while self.accept(","):
                types.append(int(self.number()))
            self.expect(")")
            return TypeIn(tuple(types))
        expr = self.expr()
        op = self.next()
        if op not in _CMP_OPS:
            raise SyntaxError(f"bad comparison {op!r}")
        return Cmp(expr, op, self.number())

    # expression grammar: expr := term (('+'|'-') term)*
    def expr(self) -> Node:
        node = self.term()
        while self.peek() in ("+", "-"):
            op = self.next()
            node = BinOp(op, node, self.term())
        return node

    def term(self) -> Node:
        node = self.factor()
        while self.peek() in ("*", "/"):
            op = self.next()
            node = BinOp(op, node, self.factor())
        return node

    def factor(self) -> Node:
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of query (expected expression)")
        if tok == "-":                      # unary minus
            self.next()
            operand = self.factor()
            if isinstance(operand, Const):
                return Const(-operand.value)
            return BinOp("-", Const(0.0), operand)
        if tok == "(":
            self.next()
            node = self.expr()
            self.expect(")")
            return node
        if tok.upper() == "CP":
            return self._cp()
        if tok.upper() == "IOU" or tok.upper() in _PAIR_FNS:
            return self._pair(tok.upper())
        if tok.upper() == "AREA":
            self.next()
            self.expect("(")
            roi = self._roi()
            self.expect(")")
            return RoiArea(roi)
        # number literal
        return Const(self.number())

    def _cp(self) -> Node:
        self.expect("CP")
        self.expect("(")
        tok = self.peek() or ""
        if tok.lower() in ("intersect", "union", "mask_agg"):
            agg = self.next().lower()
            self.expect("(")
            self.expect("mask")
            thresh = 0.5
            if self.accept(">"):
                thresh = self.number()
            self.expect(")")
            if agg == "mask_agg":
                agg = "intersect"  # MASK_AGG default: thresholded intersection
            self.expect(",")
            roi = self._roi()
            self.expect(",")
            lv, uv = self._range()
            self.expect(")")
            del lv, uv  # aggregated mask is binary; range implied
            return AggCP(agg, thresh, roi)
        self.expect("mask")
        self.expect(",")
        roi = self._roi()
        self.expect(",")
        lv, uv = self._range()
        self.expect(")")
        return CP(roi, lv, uv)

    def _role(self) -> int:
        """A pair role: a mask_type integer or a well-known role name."""
        tok = self.next()
        if tok.lower() in PAIR_ROLES:
            return PAIR_ROLES[tok.lower()]
        try:
            return int(tok)
        except ValueError as e:
            raise SyntaxError(
                f"bad mask role {tok!r}; expected a mask_type integer or "
                f"one of {sorted(PAIR_ROLES)}") from e

    def _pair(self, fn: str) -> Node:
        """Dual-mask terms (DESIGN.md §9)::

            IOU(role_a, role_b, ta, tb [, roi])
            PAIR_INTER | PAIR_UNION | PAIR_DIFF (role_a, role_b, ta, tb [, roi])

        Roles are mask_types (or the demo names saliency/attention); per
        image, role X's first mask is thresholded at ``> tX``.  ``roi``
        defaults to the full image; ``PAIR_DIFF(a, b, …)`` counts A∖B —
        swap the roles for B∖A.
        """
        self.next()
        self.expect("(")
        role_a = self._role()
        self.expect(",")
        role_b = self._role()
        self.expect(",")
        ta = self.number()
        self.expect(",")
        tb = self.number()
        roi = None
        if self.accept(","):
            roi = self._roi()
        self.expect(")")
        if fn == "IOU":
            return pair_iou(role_a, role_b, ta, tb, roi)
        return PairTerm(_PAIR_FNS[fn], role_a, role_b, ta, tb, roi)

    def _roi(self):
        tok = self.next()
        if tok.lower() == "roi":
            return "provided"
        if tok.lower() == "full_img":
            return None
        if tok == "(":
            vals = [self.number()]
            for _ in range(3):
                self.expect(",")
                vals.append(self.number())
            self.expect(")")
            return tuple(int(v) for v in vals)
        raise SyntaxError(f"bad ROI {tok!r}")

    def _range(self):
        self.expect("(")
        lv = self.number()
        self.expect(",")
        uv = self.number()
        self.expect(")")
        return lv, uv


def parse(sql: str) -> Query:
    """Parse a MaskSearch query string into an executable (compat) plan.

    A leading ``EXPLAIN [ANALYZE]`` is accepted in front of any query and
    recorded on :attr:`Query.explain` ("plan" / "analyze"); the rest of
    the statement parses exactly as it would alone."""
    with _trace.span("parse") as sp:
        tokens = _tokenize(sql)
        explain = None
        if tokens and tokens[0].upper() == "EXPLAIN":
            explain = "plan"
            tokens = tokens[1:]
            if tokens and tokens[0].upper() == "ANALYZE":
                explain = "analyze"
                tokens = tokens[1:]
        q = _Parser(tokens).parse()
        q.explain = explain
        sp.set(kind=q.kind, explain=explain or "")
    return q


def parse_plan(sql: str) -> LogicalPlan:
    """Parse straight to the composable IR (:class:`LogicalPlan`)."""
    return parse(sql).plan


def run(sql: str, store, **kw):
    """One-shot: parse + execute. Returns (result, stats)."""
    return parse(sql).run(store, **kw)


# Convenience used by examples: the paper's three scenario queries.
SCENARIO1_TOPK = (
    "SELECT mask_id FROM MasksDatabaseView "
    "ORDER BY CP(mask, roi, (0.8, 1.0)) / AREA(roi) ASC LIMIT 25;")
SCENARIO2_TOPK = (
    "SELECT mask_id FROM MasksDatabaseView "
    "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 25;")
SCENARIO3_IOU = (
    "SELECT image_id, CP(intersect(mask > 0.8), full_img, (0.5, 2.0)) "
    "/ CP(union(mask > 0.8), full_img, (0.5, 2.0)) AS iou "
    "FROM MasksDatabaseView WHERE mask_type IN (1, 2) "
    "GROUP BY image_id ORDER BY iou ASC LIMIT 25;")
SCENARIO6_DISCREPANCY = (
    "SELECT image_id FROM MasksDatabaseView "
    "ORDER BY IOU(saliency, attention, 0.6, 0.6) ASC LIMIT 25;")
