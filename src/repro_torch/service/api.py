"""MaskSearchService — the stateful layer between the SQL front-end and the
engine (the demo GUI's backend).

Responsibilities:

* **plan + cache**: parse SQL once to the logical-plan IR
  (:mod:`repro_torch.core.plan`), canonicalize it into cache keys; answer repeated
  queries from an LRU result cache (zero mask loads) and refined queries
  (same expressions, new thresholds / rearranged predicates / larger LIMIT)
  from a per-expression CHI-bounds cache (no new bounds pass).
* **sessions**: top-k queries can open a session whose pages resume the
  verification frontier incrementally (:mod:`.session`).
* **concurrency**: batches of queries — and concurrent session pages — are
  admitted together and their verification residues are merged into fused
  ``cp_count_multi`` passes behind the store's shared-load cache
  (:mod:`.scheduler`).

All public methods are thread-safe (one lock: the store's I/O meters and
caches are shared mutable state) and return JSON-serializable dicts, so the
HTTP layer in :mod:`.server` is a thin translation.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from .. import lockcheck
from ..core.backend import get_backend, is_packed
from ..core.engine import ExecStats
from ..core.plan import LogicalPlan, compile_plan
from ..core.queries import Query, parse
from ..core.store import MASK_META_DTYPE, StaleRunError
from ..obs import trace as trace_mod
from ..obs.explain import explain_analyze, explain_plan
from ..obs.metrics import REGISTRY as GLOBAL_REGISTRY
from ..obs.metrics import MetricsRegistry, dataclass_sampler
from .errors import NotFoundError
from .planner import Planner, roi_signature
from .scheduler import FusedScheduler
from .session import SessionManager

DEFAULT_PAGE = 25


def _stats_dict(stats: ExecStats) -> dict:
    d = dataclasses.asdict(stats)
    d["load_fraction"] = stats.load_fraction
    return {k: float(v) if isinstance(v, float) else int(v)
            for k, v in d.items()}


def _ids_list(ids) -> list:
    return [int(x) for x in np.asarray(ids).tolist()]


def _scores_list(scores) -> list:
    return [float(x) for x in np.asarray(scores, np.float64).tolist()]


class MaskSearchService:
    """One service per mask-store partition."""

    def __init__(self, store, *, provided_rois: Optional[np.ndarray] = None,
                 result_cache_size: int = 128, bounds_cache_size: int = 64,
                 verify_batch: int = 256, share_loads: bool = True,
                 max_sessions: int = 256, backend=None, trace: bool = False):
        self.store = store
        # The physical execution layer every plan compiles onto: the host
        # path or the device-resident tier (None → the store's own device:
        # the device backend on a CUDA store, the host backend otherwise).
        self.backend = get_backend(store, backend)
        # Representation tag folded into every planner cache key: a packed
        # store must never serve (or be served) float-era entries.
        self._packed = is_packed(store)
        self.default_rois = provided_rois
        # Hash the default ROI array once — per-query hashing of a large
        # per-mask box array would serialize O(n) work behind the lock.
        self._default_roi_sig = roi_signature(provided_rois)
        self.verify_batch = verify_batch
        self.planner = Planner(result_cache_size=result_cache_size,
                               bounds_cache_size=bounds_cache_size)
        self.sessions = SessionManager(max_sessions=max_sessions)
        self.scheduler = FusedScheduler(store, backend=self.backend)
        self._lock = lockcheck.make_rlock("service")
        # guard_dict: under REPRO_LOCK_CHECK=1, mutations of the counter
        # dict assert the service lock is held (reads stay lock-free —
        # the /metrics scrape tolerates torn reads of monotonic counts).
        self._counts = lockcheck.guard_dict(
            {"total": 0, "filter": 0, "topk": 0,
             "filtered_topk": 0, "scalar_agg": 0,
             "result_cache_hits": 0}, self._lock)
        self._started_s = time.monotonic()
        # Observability: a per-service tracer (its ring buffer backs
        # ``GET /trace/<query_id>``; ``trace=True`` traces every query, and
        # EXPLAIN ANALYZE forces it on per query regardless) and a
        # per-service metrics registry (the process-global registry carries
        # kernel/jit/backend counters and is appended at scrape time).
        self.tracer = trace_mod.Tracer(enabled=trace)
        self.metrics = MetricsRegistry()
        self._phase_hist = self.metrics.histogram(
            "masksearch_query_phase_seconds",
            "Per-query phase latency: parse, plan, bounds, verify",
            ("phase",))
        self._query_seconds = self.metrics.histogram(
            "masksearch_query_seconds",
            "End-to-end service query latency by plan kind", ("kind",))
        self._register_metrics()
        # Long-lived cross-session shared-load cache: every verification load
        # any query pays for is reusable by every later query.
        self._owns_cache = store.enable_cache() if share_loads else False

    def close(self) -> None:
        with self._lock:
            if self._owns_cache:
                self.store.clear_cache()
                self._owns_cache = False

    # -- internals --------------------------------------------------------

    def _register_metrics(self) -> None:
        """Wire every live stats object into the pull-based registry — the
        collectors sample at scrape time, so the query path never pushes."""
        reg = self.metrics
        reg.register_collector(dataclass_sampler(
            "masksearch_store_io", "counter",
            "Store I/O meters (monotonic)", lambda: self.store.io))
        reg.register_collector(dataclass_sampler(
            "masksearch_shared_cache", "counter",
            "Cross-query shared-load cache", lambda: self.store.cache_stats))
        reg.register_collector(dataclass_sampler(
            "masksearch_scheduler", "counter",
            "Fused cross-query verification scheduler",
            lambda: self.scheduler.stats))
        self.planner.register_metrics(reg)

        def _query_counts() -> list:
            counts = dict(self._counts)
            return [("masksearch_queries_total", "counter",
                     "Queries served by kind",
                     [({"kind": k}, float(v)) for k, v in counts.items()])]

        def _gauges() -> list:
            n_sess = len(self.sessions)
            return [
                ("masksearch_sessions_active", "gauge",
                 "Live interactive sessions", [({}, float(n_sess))]),
                ("masksearch_sessions_created_total", "counter",
                 "Sessions ever created",
                 [({}, float(self.sessions.created))]),
                ("masksearch_sessions_evicted_total", "counter",
                 "Sessions LRU-evicted",
                 [({}, float(self.sessions.evicted))]),
                ("masksearch_store_epoch", "gauge",
                 "Mask-store epoch (mutation counter)",
                 [({}, float(self.store.epoch))]),
                ("masksearch_store_masks", "gauge",
                 "Masks resident in the store",
                 [({}, float(len(self.store)))]),
                ("masksearch_uptime_seconds", "gauge", "Service uptime",
                 [({}, time.monotonic() - self._started_s)]),
            ]

        reg.register_collector(_query_counts)
        reg.register_collector(_gauges)

    @contextlib.contextmanager
    def _traced(self, label: str, kind: str):
        """Root query span on the service tracer when tracing is on; yields
        the root span (or None) so callers can stamp ``query_id`` into
        their payloads."""
        tr = self.tracer
        if not tr.enabled:
            yield None
            return
        with tr.activate():
            with tr.query_span(label=label) as root:
                root.set(kind=kind)
                yield root

    def _observe_phases(self, parse_s: float, build_s: float, run,
                        kind: str, total_s: float) -> None:
        ph = self._phase_hist
        ph.labels(phase="parse").observe(parse_s)
        if run is None:                      # result-cache hit: no run
            ph.labels(phase="plan").observe(build_s)
        else:
            s = run.stats
            # build_s wraps compile+ensure; carve out the metered bounds
            # and verify time so "plan" is the pure lowering cost.
            ph.labels(phase="plan").observe(
                max(build_s - s.bound_time_s - s.verify_time_s, 0.0))
            ph.labels(phase="bounds").observe(s.bound_time_s)
            ph.labels(phase="verify").observe(s.verify_time_s)
        self._query_seconds.labels(kind=kind).observe(total_s)

    def _plan(self, sql) -> LogicalPlan:
        """Normalize any front-end shape (SQL text, compat Query, or a
        LogicalPlan built directly) to the IR."""
        plan, _ = self._plan_explain(sql)
        return plan

    def _plan_explain(self, sql) -> tuple:
        """→ (LogicalPlan, explain mode) — mode is "plan"/"analyze" when the
        SQL carried an EXPLAIN [ANALYZE] prefix, else None."""
        if isinstance(sql, str):
            q = parse(sql)
            return q.plan, q.explain
        if isinstance(sql, Query):
            return sql.sync_plan(), sql.explain  # honor post-parse mutations
        return sql, None

    def _explain_payload(self, plan: LogicalPlan, mode: str, rois,
                         roi_sig: str, sql) -> dict:
        """Serve EXPLAIN / EXPLAIN ANALYZE.  ANALYZE always executes —
        never the result cache (the point is the fresh per-operator
        stats) — but goes through the bounds cache like a real query, so
        the report shows genuine cache interplay.  The trace lands in the
        service tracer's ring buffer (``GET /trace/<query_id>``)."""
        self._counts["explain"] = self._counts.get("explain", 0) + 1
        if mode == "plan":
            report = explain_plan(plan)
        else:
            report = explain_analyze(
                self.store, plan, provided_rois=rois,
                backend=self.backend, verify_batch=self.verify_batch,
                bounds_hook=self.planner.bounds_hook(
                    plan, roi_sig, self.backend.name, self.store.epoch,
                    packed=self._packed),
                tracer=self.tracer,
                label=sql if isinstance(sql, str) else plan.signature())
        report["explain"] = mode
        return report

    def _rois(self, rois):
        """→ (resolved roi array, content signature)."""
        if rois is None:
            return self.default_rois, self._default_roi_sig
        rois = np.asarray(rois)
        return rois, roi_signature(rois)

    def _build_run(self, plan: LogicalPlan, rois, roi_sig: str):
        """Compile the plan to its resumable run on the service's backend,
        going through the per-expression bounds cache (a hit skips that
        CHI pass entirely).  Bounds keys carry the store epoch, so a
        mutation can never feed a dead index's bounds into a new run."""
        return compile_plan(self.store, plan, provided_rois=rois,
                            verify_batch=self.verify_batch,
                            backend=self.backend,
                            bounds_hook=self.planner.bounds_hook(
                                plan, roi_sig, self.backend.name,
                                self.store.epoch, packed=self._packed))

    def _finish_payload(self, plan: LogicalPlan, run, *,
                        cache_hit: bool = False,
                        session_id: Optional[str] = None) -> dict:
        if plan.kind in ("topk", "filtered_topk"):
            ids, scores = run.result()
            body = {"ids": _ids_list(ids), "scores": _scores_list(scores)}
        elif plan.kind == "scalar_agg":
            value = float(run.result())
            # NaN (empty candidate set) is not valid JSON — serve null.
            body = {"value": None if np.isnan(value) else value}
        else:
            body = {"ids": _ids_list(run.result())}
        payload = {"kind": plan.kind, **body,
                   "stats": _stats_dict(run.stats), "cache_hit": cache_hit}
        if session_id is not None:
            payload["session"] = session_id
        return payload

    def _cache_hit_payload(self, cached: dict) -> dict:
        """A warm hit re-serves the stored body with zeroed I/O stats — no
        mask loads, no bounds pass (the acceptance contract).  Deep copy:
        the caller must not be able to mutate the cached ids/scores."""
        payload = copy.deepcopy(cached)
        zero = ExecStats(n_candidates=cached["stats"].get("n_candidates", 0))
        payload["stats"] = _stats_dict(zero)
        payload["cache_hit"] = True
        self._counts["result_cache_hits"] += 1
        return payload

    # -- one-shot queries -------------------------------------------------

    def query(self, sql, *, rois=None, session: bool = False,
              page_size: Optional[int] = None) -> dict:
        """Execute one query.  ``session=True`` (rankings only — plain or
        predicate-filtered top-k) opens an incremental session and returns
        its first page.  SQL carrying an ``EXPLAIN [ANALYZE]`` prefix is
        routed to the annotated-operator-tree report instead."""
        t_start = time.perf_counter()
        with self._lock:
            t0 = time.perf_counter()
            plan, explain = self._plan_explain(sql)
            parse_s = time.perf_counter() - t0
            rois, roi_sig = self._rois(rois)
            if explain is not None:
                return self._explain_payload(plan, explain, rois, roi_sig,
                                             sql)
            self._counts["total"] += 1
            self._counts[plan.kind] = self._counts.get(plan.kind, 0) + 1
            label = sql if isinstance(sql, str) else plan.signature()

            if session:
                if plan.kind not in ("topk", "filtered_topk"):
                    raise ValueError("sessions require a ranking (ORDER BY … "
                                     f"LIMIT) query, got {plan.kind!r}")
                size = page_size or plan.k or DEFAULT_PAGE
                with self._traced(label, plan.kind) as root:
                    t1 = time.perf_counter()
                    run = self._build_run(plan, rois, roi_sig)
                    build_s = time.perf_counter() - t1
                    sess = self.sessions.create(
                        sql if isinstance(sql, str) else repr(plan), run,
                        size, kind=plan.kind)
                    payload = self._serve_page(sess, size)
                if root is not None:
                    payload["query_id"] = root.attrs.get("query_id")
                self._observe_phases(parse_s, build_s, run, plan.kind,
                                     time.perf_counter() - t_start)
                return payload

            cached = self.planner.cached_result(plan, roi_sig,
                                                self.backend.name,
                                                self.store.epoch,
                                                packed=self._packed)
            if cached is not None:
                payload = self._cache_hit_payload(cached)
                self._observe_phases(parse_s, 0.0, None, plan.kind,
                                     time.perf_counter() - t_start)
                return payload

            with self._traced(label, plan.kind) as root:
                t1 = time.perf_counter()
                run = self._build_run(plan, rois, roi_sig)
                run.ensure(plan.k)
                build_s = time.perf_counter() - t1
            payload = self._finish_payload(plan, run)
            if root is not None:
                payload["query_id"] = root.attrs.get("query_id")
            self.planner.store_result(plan, roi_sig, copy.deepcopy(payload),
                                      self.backend.name, self.store.epoch,
                                      packed=self._packed)
            self._observe_phases(parse_s, build_s, run, plan.kind,
                                 time.perf_counter() - t_start)
            return payload

    def submit_batch(self, sqls: Sequence, *, rois=None) -> list:
        """Admit several queries at once; their verification residues are
        merged into fused kernel passes (the online multi-query path)."""
        with self._lock:
            rois, roi_sig = self._rois(rois)
            entries = []
            jobs = []
            for sql in sqls:
                plan, explain = self._plan_explain(sql)
                if explain is not None:
                    entries.append((plan, None, self._explain_payload(
                        plan, explain, rois, roi_sig, sql)))
                    continue
                self._counts["total"] += 1
                self._counts[plan.kind] = self._counts.get(plan.kind, 0) + 1
                cached = self.planner.cached_result(plan, roi_sig,
                                                    self.backend.name,
                                                    self.store.epoch,
                                                    packed=self._packed)
                if cached is not None:
                    entries.append((plan, None, self._cache_hit_payload(cached)))
                    continue
                # every plan kind — scalar aggregations included — compiles
                # to a resumable run, so the whole batch fuses together
                run = self._build_run(plan, rois, roi_sig)
                if plan.k is not None:
                    run.target(plan.k)
                jobs.append(run)
                entries.append((plan, run, None))
            if jobs:
                with self._traced(f"batch[{len(jobs)}]", "batch"):
                    self.scheduler.drive(jobs)
            results = []
            for plan, run, payload in entries:
                if payload is None:
                    payload = self._finish_payload(plan, run)
                    self.planner.store_result(plan, roi_sig,
                                              copy.deepcopy(payload),
                                              self.backend.name,
                                              self.store.epoch,
                                              packed=self._packed)
                results.append(payload)
            return results

    def execute_many(self, items: Sequence) -> list:
        """The async tier's admitted-batch entry point: run a heterogeneous
        batch — one-shot queries, session opens, session pages — under one
        lock acquisition and **one** fused scheduler drive, with every run
        tagged by the tenant that submitted it.  Verification residues
        from different tenants merge into the same fused kernel passes
        (``SchedulerStats.cross_tenant_*``): the paper's multi-query
        optimization applied *across users*, not just within one batch.

        Each item is a dict::

            {"op": "query", "sql": ..., "rois"?, "session"?: bool,
             "page_size"?, "tenant"?}
            {"op": "page", "session_id": ..., "k"?, "tenant"?}

        Returns a list aligned with ``items`` of ``("ok", payload)`` /
        ``("error", exc)`` — a bad item never poisons its batchmates.
        """
        with self._lock:
            results: list = [None] * len(items)
            pending: list = []            # (slot, tag, *state) to finish
            runs: list = []
            tenants: list = []

            for slot, item in enumerate(items):
                try:
                    tenant = item.get("tenant", "default")
                    if item.get("op", "query") == "page":
                        sess = self.sessions.get(item["session_id"])
                        k = item.get("k")
                        if not sess.done:
                            _, hi = sess.page_bounds(k)
                            sess.run.target(hi)
                            if not sess.run.resumable():
                                raise StaleRunError(
                                    f"session pinned at epoch "
                                    f"{sess.run.epoch}; store moved to "
                                    f"epoch {self.store.epoch}")
                            runs.append(sess.run)
                            tenants.append(tenant)
                        pending.append((slot, "page", sess, k))
                        continue

                    sql = item["sql"]
                    rois, roi_sig = self._rois(item.get("rois"))
                    plan, explain = self._plan_explain(sql)
                    if explain is not None:
                        results[slot] = ("ok", self._explain_payload(
                            plan, explain, rois, roi_sig, sql))
                        continue
                    self._counts["total"] += 1
                    self._counts[plan.kind] = \
                        self._counts.get(plan.kind, 0) + 1
                    if item.get("session"):
                        if plan.kind not in ("topk", "filtered_topk"):
                            raise ValueError(
                                "sessions require a ranking (ORDER BY … "
                                f"LIMIT) query, got {plan.kind!r}")
                        size = item.get("page_size") or plan.k or DEFAULT_PAGE
                        run = self._build_run(plan, rois, roi_sig)
                        sess = self.sessions.create(
                            sql if isinstance(sql, str) else repr(plan),
                            run, size, kind=plan.kind)
                        _, hi = sess.page_bounds(size)
                        run.target(hi)
                        runs.append(run)
                        tenants.append(tenant)
                        pending.append((slot, "open", sess, size))
                        continue
                    cached = self.planner.cached_result(
                        plan, roi_sig, self.backend.name, self.store.epoch,
                        packed=self._packed)
                    if cached is not None:
                        results[slot] = ("ok",
                                         self._cache_hit_payload(cached))
                        continue
                    run = self._build_run(plan, rois, roi_sig)
                    if plan.k is not None:
                        run.target(plan.k)
                    runs.append(run)
                    tenants.append(tenant)
                    pending.append((slot, "oneshot", plan, run, roi_sig))
                except Exception as e:      # noqa: BLE001 — per-item fault
                    results[slot] = ("error", e)

            if runs:
                with self._traced(f"admit[{len(runs)}]", "admitted_batch"):
                    self.scheduler.drive(runs, tenants=tenants)

            for entry in pending:
                slot, tag = entry[0], entry[1]
                try:
                    if tag == "oneshot":
                        _, _, plan, run, roi_sig = entry
                        payload = self._finish_payload(plan, run)
                        self.planner.store_result(
                            plan, roi_sig, copy.deepcopy(payload),
                            self.backend.name, self.store.epoch,
                            packed=self._packed)
                    else:                   # "open" | "page"
                        _, _, sess, k = entry
                        payload = self._serve_page(sess, k,
                                                   scheduler_driven=True)
                    results[slot] = ("ok", payload)
                except Exception as e:      # noqa: BLE001 — per-item fault
                    results[slot] = ("error", e)
            return results

    # -- sessions ---------------------------------------------------------

    def _serve_page(self, sess, k: Optional[int], *,
                    scheduler_driven: bool = False) -> dict:
        lo, hi = sess.page_bounds(k)
        if sess.done:
            hi = lo                              # nothing left to deliver
        elif not scheduler_driven:
            sess.run.ensure(hi)
        ids, scores = sess.run.result(hi)
        page_ids, page_scores = ids[lo:hi], scores[lo:hi]
        if not sess.done and len(ids) < hi:
            # Fewer qualifying rows than the target: the run drained every
            # possibly-qualifying candidate (a filtered ranking whose
            # predicate matched < hi rows) — the result set is complete.
            sess.done = True
        sess.served = min(hi, len(ids)) if sess.done else hi
        sess.pages_served += 1
        return {"kind": sess.kind, "session": sess.id,
                "page": {"offset": lo, "ids": _ids_list(page_ids),
                         "scores": _scores_list(page_scores)},
                "served": sess.served, "total_candidates": sess.run.n,
                "exhausted": sess.exhausted,
                "stats": _stats_dict(sess.run.stats), "cache_hit": False}

    def next_page(self, session_id: str, k: Optional[int] = None) -> dict:
        """Resume a session's verification frontier for the next page."""
        t_start = time.perf_counter()
        with self._lock:
            sess = self.sessions.get(session_id)
            v0 = sess.run.stats.verify_time_s
            with self._traced(f"session:{session_id}", sess.kind) as root:
                payload = self._serve_page(sess, k)
            if root is not None:
                payload["query_id"] = root.attrs.get("query_id")
            self._phase_hist.labels(phase="verify").observe(
                sess.run.stats.verify_time_s - v0)
            self._query_seconds.labels(kind="page").observe(
                time.perf_counter() - t_start)
            return payload

    def next_pages(self, requests: dict) -> dict:
        """Advance several sessions at once: their frontiers are fused into
        shared verification passes.  ``requests`` maps session_id → k
        (None → session page size).  A session whose run can no longer be
        served consistently (the store mutated and its snapshot cannot
        finish) gets a per-session ``stale`` error entry instead of
        poisoning the whole batch."""
        with self._lock:
            sessions = []
            stale = {}
            for sid, k in requests.items():
                sess = self.sessions.get(sid)
                if not sess.done:
                    _, hi = sess.page_bounds(k)
                    sess.run.target(hi)
                sessions.append((sess, k))
            live = []
            for sess, k in sessions:
                if sess.done or sess.run.resumable():
                    live.append((sess, k))
                else:
                    stale[sess.id] = {
                        "session": sess.id, "stale": True,
                        "error": f"session pinned at epoch "
                                 f"{sess.run.epoch}; store moved to epoch "
                                 f"{self.store.epoch}"}
            with self._traced(f"pages[{len(live)}]", "page_batch"):
                self.scheduler.drive([s.run for s, _ in live])
                out = {s.id: self._serve_page(s, k, scheduler_driven=True)
                       for s, k in live}
            out.update(stale)
            return out

    def drop_session(self, session_id: str) -> bool:
        with self._lock:
            return self.sessions.drop(session_id)

    # -- mutation (the epoch-versioned write path) ------------------------

    def ingest(self, masks, *, mask_ids=None, image_ids=None, model_ids=None,
               mask_types=None, on_conflict: str = "error") -> dict:
        """Append (or, with ``on_conflict="update"``, upsert) masks.

        The model-iteration workflow: a retrained model's regenerated
        saliency maps re-ingest under their existing mask_ids (bytes +
        CHI rows replaced incrementally), new masks append as a new CHI
        chunk.  Either way the store epoch advances, every cached result
        and bounds entry from before the ingest becomes unreachable, and
        in-flight sessions keep their pinned-epoch view (or report
        staleness on their next page).

        Metadata on the update path: fields the caller supplies
        (``image_ids``/``model_ids``/``mask_types``) replace the existing
        rows' values; omitted fields keep their current values.  New rows
        default to ``image_id=mask_id``, ``model_id=0``, ``mask_type=1``.
        """
        if on_conflict not in ("error", "update"):
            raise ValueError(f"on_conflict must be 'error' or 'update', "
                             f"got {on_conflict!r}")
        with self._lock:
            masks = np.asarray(masks, np.float32)
            if masks.ndim == 2:
                masks = masks[None]
            n = len(masks)
            existing = self.store.mask_ids
            if mask_ids is None:
                base = int(existing.max()) + 1 if len(existing) else 0
                mask_ids = np.arange(base, base + n, dtype=np.int64)
            else:
                mask_ids = np.asarray(mask_ids, np.int64)
                if len(mask_ids) != n:
                    raise ValueError("mask_ids length must match masks")
            meta = np.zeros(n, MASK_META_DTYPE)
            meta["mask_id"] = mask_ids
            meta["image_id"] = (mask_ids if image_ids is None
                                else np.asarray(image_ids, np.int64))
            meta["model_id"] = (0 if model_ids is None
                                else np.asarray(model_ids, np.int32))
            meta["mask_type"] = (1 if mask_types is None
                                 else np.asarray(mask_types, np.int32))
            known = np.isin(mask_ids, existing)
            if np.any(known) and on_conflict == "error":
                raise ValueError(
                    f"{int(known.sum())} mask_ids already exist; pass "
                    f"on_conflict='update' to replace their bytes")
            n_updated = n_appended = 0
            if np.any(known):
                upd_meta = None
                if any(a is not None
                       for a in (image_ids, model_ids, mask_types)):
                    pos = self.store.positions_of(mask_ids[known])
                    upd_meta = self.store.meta[pos].copy()
                    for field, arg in (("image_id", image_ids),
                                       ("model_id", model_ids),
                                       ("mask_type", mask_types)):
                        if arg is not None:
                            upd_meta[field] = meta[field][known]
                self.store.update(mask_ids[known], masks[known],
                                  meta=upd_meta)
                n_updated = int(known.sum())
            if np.any(~known):
                self.store.append(masks[~known], meta[~known])
                n_appended = int((~known).sum())
            # The mutation retired every pre-epoch cache generation; sweep
            # it out instead of letting dead entries squat in the LRUs.
            evicted = self.planner.evict_dead_epochs(self.store.epoch)
            return {"epoch": self.store.epoch, "appended": n_appended,
                    "updated": n_updated, "n_masks": len(self.store),
                    "evicted_cache_entries": evicted,
                    "mask_ids": _ids_list(mask_ids)}

    def delete(self, mask_ids) -> dict:
        """Delete masks by id; positions renumber, epoch advances."""
        with self._lock:
            ids = np.unique(np.atleast_1d(np.asarray(mask_ids, np.int64)))
            self.store.delete(ids)
            evicted = self.planner.evict_dead_epochs(self.store.epoch)
            return {"epoch": self.store.epoch, "deleted": int(len(ids)),
                    "evicted_cache_entries": evicted,
                    "n_masks": len(self.store)}

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            io = self.store.io
            cache = self.store.cache_stats
            phases = {labels.get("phase", "_"): child.summary()
                      for labels, child in self._phase_hist.samples()}
            return {
                "uptime_s": time.monotonic() - self._started_s,
                "backend": self.backend.name,
                "epoch": self.store.epoch,
                "n_masks": len(self.store),
                "queries": dict(self._counts),
                **self.planner.stats(),
                "sessions": self.sessions.stats(),
                "scheduler": self.scheduler.stats.as_dict(),
                "phases": phases,
                "trace": {"enabled": self.tracer.enabled,
                          "retained": self.tracer.trace_ids()},
                # Reflected, not hand-listed: a field added to IOStats or
                # CacheStats shows up here (and in /metrics) automatically.
                "store_io": {**dataclasses.asdict(io),
                             "modeled_ebs_time_s": io.modeled_ebs_time_s},
                "shared_cache": {**dataclasses.asdict(cache),
                                 "hit_rate": cache.hit_rate},
            }

    def metrics_text(self) -> str:
        """The Prometheus text exposition ``GET /metrics`` serves: this
        service's registry (queries, phases, store I/O, caches, sessions)
        followed by the process-global registry (kernel launches, jit
        compiles, backend resolutions)."""
        return (self.metrics.prometheus_text() +
                GLOBAL_REGISTRY.prometheus_text())

    def trace(self, query_id: str = "last", *, fmt: str = "json") -> dict:
        """A retained trace by query id (``"last"`` → most recent), as
        nested JSON or, with ``fmt="chrome"``, the Chrome trace-event
        format (load in Perfetto / chrome://tracing)."""
        root = (self.tracer.last_trace() if query_id in ("", "last")
                else self.tracer.get_trace(query_id))
        if root is None:
            raise NotFoundError(f"no retained trace for {query_id!r}; "
                                f"retained: {self.tracer.trace_ids()}")
        if fmt == "chrome":
            return trace_mod.chrome_trace(root)
        return root.to_dict()
