"""PyTorch port: tracing, EXPLAIN [ANALYZE] and metrics against the JAX
package.

Mirrors ``tests/test_obs.py`` case by case over the same 24-mask store
(the port's on the CPU): span-tree structures, EXPLAIN and EXPLAIN ANALYZE
reports (trees, text, stats, traces) and the Prometheus exposition must be
equal to the JAX package's with timing fields removed
(``test_torch_service.plain``), on the host, device and mesh backends.
"""

import json

import numpy as np
import pytest

from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from test_torch_service import JAX, TORCH, both, create_memory, \
    metric_names

B, H, W = 24, 32, 32
BACKENDS = ("host", "device", "mesh")

CP_SQL = ("SELECT mask_id FROM V "
          "ORDER BY CP(mask, roi, (0.8, 1.0)) / AREA(roi) ASC LIMIT 10;")
PAIR_SQL = ("SELECT image_id FROM V "
            "ORDER BY IOU(saliency, attention, 0.6, 0.6) ASC LIMIT 6;")
AGG_SQL = "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.2, 0.6))) FROM V;"
FILTERED_SQL = ("SELECT mask_id FROM V "
                "WHERE CP(mask, full_img, (0.2, 0.6)) > 50 "
                "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 8;")


@pytest.fixture(scope="module")
def db():
    """Package name → store, and the ROIs."""
    rois = object_boxes(B, H, W, seed=5)
    masks, _ = saliency_masks(B, H, W, seed=4, attacked_fraction=0.25,
                              boxes=rois)
    meta = np.zeros(B, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(B)
    meta["image_id"] = np.arange(B) // 2
    meta["mask_type"] = np.arange(B) % 2 + 1   # pairs: (1, 2) per image
    cfg = dict(grid=4, num_bins=8, height=H, width=W)
    return {P.name: create_memory(P, masks, meta, cfg)
            for P in (JAX, TORCH)}, rois


# -- tracer mechanics --------------------------------------------------------


def test_disabled_tracer_allocates_no_spans(db):
    def scenario(P):
        before = P.trace.GLOBAL_TRACER.spans_started
        P.queries.run(CP_SQL, db[0][P.name], provided_rois=db[1])
        return (P.trace.GLOBAL_TRACER.spans_started - before,
                P.trace.span("anything") is P.trace.NOOP_SPAN)
    assert both(scenario) == (0, True)


def test_span_tree_nesting_and_ring_buffer():
    def scenario(P):
        t = P.trace.Tracer(enabled=True)
        with t.activate():
            with t.query_span(label="q") as root:
                with P.trace.span("bounds") as sp:
                    sp.set(candidates=7)
                with P.trace.span("verify.round") as sp:
                    sp.set(batch=3)
        qid = root.attrs["query_id"]
        t2 = P.trace.Tracer(enabled=True, max_traces=2)
        with t2.activate():
            for _ in range(4):
                with t2.query_span():
                    pass
        return (root.to_dict(), [c.name for c in root.children],
                t.get_trace(qid) is root, t.last_trace() is root,
                t.spans_started, t2.trace_ids())
    _, names, by_id, last, started, kept = both(scenario)
    assert names == ["bounds", "verify.round"] and by_id and last
    assert started == 3 and len(kept) == 2


def test_trace_exports_round_trip():
    def scenario(P):
        t = P.trace.Tracer(enabled=True)
        with t.activate():
            with t.query_span(label="export") as root:
                with P.trace.span("bounds") as sp:
                    sp.set(candidates=np.int64(5), chi_bytes=np.int32(640))
        return (json.loads(json.dumps(root.to_dict())),
                json.loads(json.dumps(P.trace.chrome_trace(root))))
    d, ch = both(scenario)
    assert d["name"] == "query" and d["children"][0]["name"] == "bounds"
    assert {e["name"] for e in ch["traceEvents"]} == {"query", "bounds"}
    assert all(e["ph"] == "X" for e in ch["traceEvents"])


# -- backend-invariant span structure ---------------------------------------


@pytest.mark.parametrize("sql", [CP_SQL, PAIR_SQL, AGG_SQL, FILTERED_SQL],
                         ids=["cp", "pair", "agg", "filtered_topk"])
def test_span_structure_identical_across_backends(db, sql):
    def scenario(P):
        out = {}
        for backend in BACKENDS:
            t = P.trace.Tracer(enabled=True)
            rep = P.explain.explain_analyze(
                db[0][P.name], P.queries.parse(sql).plan,
                provided_rois=db[1], backend=backend, verify_batch=5,
                tracer=t)
            out[backend] = (t.last_trace().structure(), rep)
        return out
    out = both(scenario)
    assert out["device"][0] == out["host"][0]
    s0 = out["host"][1]["tree"]["stats"]
    s = out["device"][1]["tree"]["stats"]
    for key in ("candidates", "decided_by_bounds", "verified", "rounds"):
        assert s[key] == s0[key], key


# -- EXPLAIN [ANALYZE] -------------------------------------------------------


def test_explain_grammar_prefix():
    def scenario(P):
        q = P.queries.parse("EXPLAIN ANALYZE " + CP_SQL)
        return (q.explain, q.kind, P.queries.parse("EXPLAIN " + CP_SQL).explain,
                P.queries.parse(CP_SQL).explain)
    assert both(scenario) == ("analyze", "topk", "plan", None)


def test_explain_plan_is_not_executed(db):
    def scenario(P):
        store = db[0][P.name]
        io0 = store.io.bytes_read
        rep = P.queries.parse("EXPLAIN " + CP_SQL).run(store)
        return rep, store.io.bytes_read - io0
    rep, loads = both(scenario)
    assert rep["analyzed"] is False and loads == 0
    assert [c["op"] for c in rep["tree"]["children"]] == ["CHIBounds",
                                                          "Source"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sql", [CP_SQL, PAIR_SQL, FILTERED_SQL],
                         ids=["cp", "pair", "filtered_topk"])
def test_explain_analyze_operator_stats(db, sql, backend):
    def scenario(P):
        store, rois = db[0][P.name], db[1]
        plan = P.queries.parse(sql).plan
        rep = P.explain.explain_analyze(store, plan, provided_rois=rois,
                                        backend=backend, verify_batch=5)
        result = P.plan.run_plan(store, plan, provided_rois=rois,
                                 verify_batch=5, backend=backend)
        return rep, result
    rep, (result, _) = both(scenario)
    assert rep["analyzed"] is True and rep["backend"] == backend
    root = rep["tree"]
    stats = root["stats"]
    for key in ("candidates", "decided_by_bounds", "verified", "rounds",
                "bytes_loaded", "bytes_saved", "bound_time_s",
                "verify_time_s"):
        assert key in stats, key
    assert stats["candidates"] > 0
    decided = stats["decided_by_bounds"] + stats["verified"]
    if "WHERE" in sql:
        assert 0 < decided <= stats["candidates"]
    else:
        assert decided == stats["candidates"]
    ops = {c["op"]: c for c in root["children"]}
    assert "Verify" in ops and "CHIBounds" in ops and "Source" in ops
    assert len(ops["Verify"]["rounds"]) == stats["rounds"]
    assert sum(r["bytes_loaded"] for r in ops["Verify"]["rounds"]) \
        == stats["bytes_loaded"]
    for row in ops["CHIBounds"]["exprs"]:
        assert row["candidates"] == stats["candidates"]
        assert row["chi_bytes"] > 0
    if "WHERE" in sql:
        leaves = ops["Filter"]["leaves"]
        assert leaves and all(
            leaf["accepted_by_bounds"] + leaf["rejected_by_bounds"]
            + leaf["undecided"] == stats["candidates"] for leaf in leaves)
    json.loads(json.dumps(rep))
    assert rep["n_results"] == len(result[0])


def test_explain_analyze_scalar_agg(db):
    def scenario(P):
        store, rois = db[0][P.name], db[1]
        plan = P.queries.parse(AGG_SQL).plan
        return (P.explain.explain_analyze(store, plan, provided_rois=rois),
                P.plan.run_plan(store, plan, provided_rois=rois))
    rep, (value, _) = both(scenario)
    assert rep["value"] == value and rep["tree"]["op"] == "Aggregate"


def test_explain_analyze_restores_tracer_state(db):
    def scenario(P):
        t = P.trace.Tracer(enabled=False)
        P.explain.explain_analyze(db[0][P.name], P.queries.parse(CP_SQL).plan,
                                  provided_rois=db[1], tracer=t)
        return t.enabled, t.last_trace().to_dict()
    enabled, trace = both(scenario)
    assert enabled is False and trace     # forced on for the query only


def test_explain_plan_render_smoke():
    rep = both(lambda P: P.explain.explain_plan(
        P.queries.parse(FILTERED_SQL).plan))
    assert "TopK" in rep["text"] and "Filter" in rep["text"]


# -- metrics registry --------------------------------------------------------


def _parse_prometheus(text):
    samples, typed = {}, {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ")
            typed[name] = mtype
            continue
        if line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        samples[name_labels] = float(value)
    return samples, typed


def test_registry_counter_gauge_histogram():
    def scenario(P):
        reg = P.metrics.MetricsRegistry()
        c = reg.counter("t_total", "help", ("kind",))
        c.labels(kind="a").inc()
        c.labels(kind="a").inc(2)
        reg.gauge("t_gauge", "help").set(4.5)
        h = reg.histogram("t_seconds", "help", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return (reg.prometheus_text(), h.labels().summary(),
                reg.counter("t_total") is c,
                type(pytest.raises(ValueError, reg.gauge, "t_total").value))
    text, summ, same_family, mismatch = both(scenario)
    samples, typed = _parse_prometheus(text)
    assert samples['t_total{kind="a"}'] == 3 and samples["t_gauge"] == 4.5
    assert samples['t_seconds_bucket{le="0.1"}'] == 1
    assert samples['t_seconds_bucket{le="1"}'] == 2
    assert samples['t_seconds_bucket{le="+Inf"}'] == 3
    assert samples["t_seconds_count"] == 3
    assert samples["t_seconds_sum"] == pytest.approx(5.55)
    assert typed == {"t_total": "counter", "t_gauge": "gauge",
                     "t_seconds": "histogram"}
    assert summ["count"] == 3 and 0.0 < summ["p50"] <= 1.0
    assert same_family and mismatch is ValueError


def test_registry_collectors_reflect_dataclasses():
    import dataclasses as dc

    @dc.dataclass
    class S:
        reads: int = 3
        frac: float = 0.5
        name: str = "x"       # non-numeric: skipped

    def scenario(P):
        reg = P.metrics.MetricsRegistry()
        reg.register_collector(P.metrics.dataclass_sampler(
            "t_s", "counter", "h", lambda: S()))
        return reg.prometheus_text()
    samples, _ = _parse_prometheus(both(scenario))
    assert samples == {"t_s_reads": 3.0, "t_s_frac": 0.5}


def test_kernel_launch_metrics_populated(db):
    """After the same query, both global registries carry launch counts and
    backend resolutions, under the same registered metric families."""
    out = {}
    for P in (JAX, TORCH):
        P.queries.run(CP_SQL, db[0][P.name], provided_rois=db[1])
        samples, _ = _parse_prometheus(P.metrics.REGISTRY.prometheus_text())
        launches = {k: v for k, v in samples.items()
                    if k.startswith("masksearch_kernel_launches_total")}
        assert any(v > 0 for v in launches.values()), (P.name, launches)
        assert any(k.startswith("masksearch_backend_resolutions_total")
                   for k in samples)
        out[P.name] = (sorted(P.metrics.REGISTRY._families),
                       metric_names(P.metrics.REGISTRY.prometheus_text()))
    assert out[TORCH.name][0] == out[JAX.name][0]
    # What a process-wide registry exports depends on what ran before it in
    # this worker, so the exported names are held equal in fresh processes
    # (test_service_metrics_names_equal_in_fresh_processes).
    assert {"masksearch_kernel_launches_total",
            "masksearch_kernel_dispatch_seconds",
            "masksearch_jit_compiles_total",
            "masksearch_backend_resolutions_total"} <= out[TORCH.name][1]


# One package's service in a fresh process: the same requests over HTTP,
# then the metric names its GET /metrics exports, as JSON on the last line.
_SCRAPE = """
import importlib, json, sys, threading
pkg, backend = sys.argv[1], sys.argv[2]
server = importlib.import_module(pkg + ".service.server")
svc_mod = importlib.import_module(pkg + ".service")
dev = {"device": "cpu"} if pkg == "repro_torch" else {}
store, rois = server._synthetic_store(60, 32, **dev)
service = svc_mod.MaskSearchService(store, provided_rois=rois,
                                    backend=backend, trace=True)
httpd = server.make_server(service, "127.0.0.1", 0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
host, port = httpd.server_address[:2]
c = svc_mod.ServiceClient(f"http://{host}:{port}", timeout=120)
top = "SELECT mask_id FROM V ORDER BY CP(mask, roi, (0.5, 1.0)) DESC LIMIT 5;"
c.query(top)
c.query(top)
s = c.query(top.replace("LIMIT 5", "LIMIT 20"), session=True, page_size=5)
c.next_page(s["session"])
c.workload([top,
            "SELECT mask_id FROM V WHERE CP(mask, full_img, (0.2, 0.6)) > 50;",
            "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.2, 0.6))) FROM V;",
            "SELECT image_id FROM V "
            "ORDER BY IOU(saliency, attention, 0.6, 0.6) ASC LIMIT 6;"])
c.query("EXPLAIN ANALYZE " + top)
c.stats()
text = c.metrics()
httpd.shutdown()
httpd.server_close()
service.close()
print(json.dumps(sorted({ln.split()[2] for ln in text.splitlines()
                         if ln.startswith("# TYPE ")})))
"""


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_metrics_names_equal_in_fresh_processes(backend):
    """After the same requests, each package's service — alone in a fresh
    process — exports the same metric names on ``GET /metrics``."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu")
    names = {}
    for P in (JAX, TORCH):
        out = subprocess.run([sys.executable, "-c", _SCRAPE, P.name, backend],
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        names[P.name] = set(json.loads(out.stdout.splitlines()[-1]))
    assert names[TORCH.name] == names[JAX.name]
    assert {"masksearch_queries_total", "masksearch_kernel_launches_total",
            "masksearch_jit_compiles_total"} <= names[TORCH.name]
