"""EXPLAIN ANALYZE — the annotated operator tree behind a query.

:func:`explain_analyze` executes a :class:`~repro_torch.core.plan.LogicalPlan`
under a (forced-on) tracer and reassembles the run's stats, the per-leaf
bound decisions, and the trace's per-phase spans into one JSON-friendly
operator tree plus a ``postgres``-style text rendering::

    TopK(k=25, asc, by=CP(mask, roi, (0.8, 1.0)) / AREA(roi))
      [candidates=600 decided_by_bounds=547 verified=53 bytes=868352 ...]
      -> Verify   [rounds=3 verified=53 bytes_loaded=868352 ...]
      -> CHIBounds [time_s=0.0021]
           CP(roi='provided', lv=0.8, uv=1.0): candidates=600 ...
      -> Source   [unit=mask candidates=600 mask_types=None]

The same structure is produced on every execution backend (host /
device) — candidates, decided-by-bounds, and verified counts are bit-identical
by the backend contract; only the timings differ.

``EXPLAIN <query>`` (without ANALYZE) goes through :func:`explain_plan`:
the logical operator tree only, nothing executed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.exprs import (And, GroupEvalContext, Not, Or,
                          PairEvalContext, Pred)
from ..core.plan import LogicalPlan, compile_plan
from . import trace as trace_mod

__all__ = ["explain_plan", "explain_analyze", "render_text"]


def _pred_leaves(pred: Optional[Pred]) -> list:
    if pred is None:
        return []
    if isinstance(pred, (And, Or)):
        return _pred_leaves(pred.left) + _pred_leaves(pred.right)
    if isinstance(pred, Not):
        return _pred_leaves(pred.child)
    return [pred]


def _unit_of(ctx) -> str:
    if isinstance(ctx, PairEvalContext):
        return "image_pair"
    if isinstance(ctx, GroupEvalContext):
        return "image_group"
    return "mask"


def _root_op(plan: LogicalPlan) -> dict:
    kind = plan.kind
    if kind in ("topk", "filtered_topk"):
        return {"op": "TopK", "k": plan.k,
                "order": "desc" if plan.desc else "asc",
                "by": repr(plan.order_by)}
    if kind == "scalar_agg":
        return {"op": "Aggregate", "agg": plan.agg,
                "expr": repr(plan.agg_expr)}
    return {"op": "Filter", "predicate": repr(plan.predicate)}


def explain_plan(plan: LogicalPlan) -> dict:
    """``EXPLAIN`` (no ANALYZE): the logical operator tree, not executed."""
    plan.validate()
    root = _root_op(plan)
    children = []
    if plan.kind == "filtered_topk":
        children.append({"op": "Filter", "predicate": repr(plan.predicate)})
    children.append({"op": "CHIBounds",
                     "exprs": [{"expr": repr(e)} for e in plan.exprs()]})
    children.append({"op": "Source",
                     "mask_types": (None if plan.mask_types is None
                                    else list(plan.mask_types)),
                     "grouped": plan.grouped, "paired": plan.paired})
    root["children"] = children
    tree = {"kind": plan.kind, "analyzed": False, "tree": root}
    tree["text"] = render_text(root)
    return tree


def _bounds_rows(trace_root) -> list:
    """Per-expression bounds spans (classic ``bounds`` passes and pyramid
    ``bounds.tier`` rungs) pulled out of the trace.  Tier rungs carry the
    grid they ran at, so the rendered CHIBounds node shows the refinement
    ladder actually used and the index bytes each rung touched."""
    rows = []
    if trace_root is None:
        return rows
    for sp in trace_root.walk():
        if sp.name == "bounds":
            rows.append({"expr": sp.attrs.get("expr"),
                         "candidates": sp.attrs.get("candidates"),
                         "chi_bytes": sp.attrs.get("chi_bytes", 0),
                         "cached": bool(sp.attrs.get("cached", False)),
                         "time_s": sp.dur_s})
        elif sp.name == "bounds.tier":
            rows.append({"expr": sp.attrs.get("expr"),
                         "tier": sp.attrs.get("tier"),
                         "candidates": sp.attrs.get("candidates"),
                         "chi_bytes": sp.attrs.get("chi_bytes", 0),
                         "time_s": sp.dur_s})
    return rows


def _verify_rounds(trace_root) -> list:
    rounds = []
    if trace_root is None:
        return rounds
    for sp in trace_root.walk():
        if sp.name == "verify.round":
            rounds.append({"batch": sp.attrs.get("batch"),
                           "bytes_loaded": sp.attrs.get("bytes_loaded", 0),
                           "bytes_saved": sp.attrs.get("bytes_saved", 0),
                           "cache_hits": sp.attrs.get("cache_hits", 0),
                           "time_s": sp.dur_s})
    return rounds


def analyzed_tree(plan: LogicalPlan, run, trace_root=None) -> dict:
    """Annotate the operator tree with a finished run's per-operator stats.

    Works for any run produced by :func:`~repro_torch.core.plan.compile_plan`
    (CP, pair, grouped, and filtered-top-k alike) on any backend."""
    s = run.stats
    root = _root_op(plan)
    root["stats"] = {
        "candidates": int(s.n_candidates),
        "decided_by_bounds": int(s.n_decided_by_bounds),
        "verified": int(s.n_verified),
        "rounds": int(s.n_rounds),
        "bytes_loaded": int(s.bytes_loaded),
        "bytes_saved": int(s.bytes_saved),
        "chi_bytes": int(s.chi_bytes),
        "bound_time_s": float(s.bound_time_s),
        "verify_time_s": float(s.verify_time_s),
        "load_fraction": float(s.load_fraction),
    }
    children = [{
        "op": "Verify",
        "stats": {"rounds": int(s.n_rounds), "verified": int(s.n_verified),
                  "bytes_loaded": int(s.bytes_loaded),
                  "bytes_saved": int(s.bytes_saved),
                  "time_s": float(s.verify_time_s)},
        "rounds": _verify_rounds(trace_root),
    }]
    if plan.predicate is not None:
        opt_report = getattr(run, "opt_report", None)
        if opt_report is not None:
            # the cost-based optimizer ran: report the conjunct order it
            # chose, each conjunct's estimated vs. actual rejection rate,
            # and the tier ladder it walked (re-deciding here would redo
            # un-memoized ladder passes and distort the stats)
            leaves = []
            for row in opt_report["conjuncts"]:
                entry = {"pred": row["pred"],
                         "start_tier": row["start_tier"]}
                if row.get("classic"):
                    entry["classic"] = True
                if row.get("est_reject") is not None:
                    entry["est_reject"] = round(float(row["est_reject"]), 4)
                if row.get("actual_reject") is not None:
                    entry["actual_reject"] = round(
                        float(row["actual_reject"]), 4)
                entry["evaluated"] = int(row.get("evaluated", 0))
                if row.get("tiers"):
                    entry["ladder"] = " -> ".join(
                        f"g{t['grid']}[{t['candidates']}cand "
                        f"{t['accepted']}acc {t['rejected']}rej]"
                        for t in row["tiers"])
                leaves.append(entry)
            children.append({"op": "Filter",
                             "predicate": repr(plan.predicate),
                             "order": list(opt_report["order"]),
                             "reordered": bool(opt_report["reordered"]),
                             "tier_grids": list(opt_report["tier_grids"]),
                             "leaves": leaves})
        else:
            # classic decide: leaf bounds are memoized on the run, so
            # re-deciding per leaf is free and exact
            leaves = []
            for leaf in _pred_leaves(plan.predicate):
                accept, reject = leaf.decide(run.expr_bounds, run.ctx)
                accept = np.asarray(accept, bool)
                reject = np.asarray(reject, bool)
                leaves.append({
                    "pred": repr(leaf),
                    "accepted_by_bounds": int(accept.sum()),
                    "rejected_by_bounds": int(reject.sum()),
                    "undecided": int((~(accept | reject)).sum()),
                })
            children.append({"op": "Filter",
                             "predicate": repr(plan.predicate),
                             "leaves": leaves})
    children.append({"op": "CHIBounds",
                     "stats": {"time_s": float(s.bound_time_s),
                               "chi_bytes": int(s.chi_bytes)},
                     "exprs": (_bounds_rows(trace_root) or
                               [{"expr": repr(e)} for e in plan.exprs()])})
    children.append({"op": "Source",
                     "unit": _unit_of(run.ctx),
                     "candidates": int(s.n_candidates),
                     "mask_types": (None if plan.mask_types is None
                                    else list(plan.mask_types)),
                     "dropped_masks": int(s.n_dropped_masks),
                     "packed": bool(getattr(run.ctx.store, "packed",
                                            False))})
    root["children"] = children
    return root


def _stats_line(d: dict) -> str:
    parts = []
    for k, v in d.items():
        if isinstance(v, float):
            parts.append(f"{k}={v:.4g}")
        else:
            parts.append(f"{k}={v}")
    return " ".join(parts)


def render_text(node: dict, indent: int = 0) -> str:
    """Indented text rendering of an (analyzed or plain) operator tree."""
    pad = "  " * indent
    head = node.get("op", "?")
    detail = {k: v for k, v in node.items()
              if k not in ("op", "children", "stats", "leaves", "exprs",
                           "rounds")}
    line = pad + ("-> " if indent else "") + head
    if detail:
        line += "(" + ", ".join(f"{k}={v}" for k, v in detail.items()) + ")"
    if node.get("stats"):
        line += f"  [{_stats_line(node['stats'])}]"
    out = [line]
    for leaf in node.get("leaves", ()):
        out.append(pad + "     " + _stats_line(leaf))
    for row in node.get("exprs", ()):
        out.append(pad + "     " + _stats_line(row))
    for child in node.get("children", ()):
        out.append(render_text(child, indent + 1))
    return "\n".join(out)


def explain_analyze(store, plan: LogicalPlan, *, provided_rois=None,
                    backend=None, verify_batch: Optional[int] = None,
                    bounds_hook=None, tracer: Optional[trace_mod.Tracer] = None,
                    label: str = "") -> dict:
    """Execute ``plan`` under a tracer and return the annotated report:

    ``{"query_id", "kind", "backend", "analyzed": True, "tree", "text",
    "stats", "trace", "chrome_trace", "n_results"/"value"}``

    Tracing is forced on for this query even when the ambient tracer is
    disabled (an explicitly requested EXPLAIN ANALYZE must not come back
    empty); pass ``tracer=`` to retain the trace in a specific ring buffer
    (the service passes its own, so ``GET /trace/<query_id>`` can replay
    it)."""
    plan.validate()
    t = tracer if tracer is not None else trace_mod.current_tracer()
    was_enabled = t.enabled
    t.enabled = True
    if verify_batch is None:
        ranked = plan.kind in ("topk", "filtered_topk") or (
            plan.kind == "scalar_agg" and plan.agg in ("MIN", "MAX"))
        verify_batch = 256 if ranked else max(len(store), 1)
    try:
        with t.activate():
            with t.query_span(label=label or plan.signature()) as root:
                root.set(kind=plan.kind, explain="analyze")
                run = compile_plan(store, plan,
                                   provided_rois=provided_rois,
                                   verify_batch=verify_batch,
                                   bounds_hook=bounds_hook,
                                   backend=backend)
                run.ensure(plan.k)
                result = run.result()
                if plan.kind in ("topk", "filtered_topk"):
                    root.set(n_results=len(result[0]))
                elif plan.kind == "filter":
                    root.set(n_results=len(result))
    finally:
        t.enabled = was_enabled

    tree = analyzed_tree(plan, run, root)
    report = {
        "query_id": root.attrs.get("query_id"),
        "kind": plan.kind,
        "analyzed": True,
        "backend": run.backend.name,
        "tree": tree,
        "text": render_text(tree),
        "stats": run.stats.as_dict(),
        "trace": root.to_dict(),
        "chrome_trace": trace_mod.chrome_trace(root),
    }
    if plan.kind == "scalar_agg":
        value = float(result)
        report["value"] = None if np.isnan(value) else value
    else:
        report["n_results"] = (len(result[0])
                               if plan.kind in ("topk", "filtered_topk")
                               else len(result))
    return report


def stats_fields(obj) -> list:
    """Names of the numeric fields of a stats dataclass (reflection used by
    the drift tests and the metrics adapters)."""
    return [f.name for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), (int, float))
            and not isinstance(getattr(obj, f.name), bool)]
