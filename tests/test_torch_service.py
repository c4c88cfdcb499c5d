"""PyTorch port: the query service against the JAX service, case by case.

Each test mirrors one of ``tests/test_service.py``: the same requests go to
the JAX package's ``MaskSearchService`` and to the port's, over stores built
from the same numpy inputs (the port's on ``device="cpu"``, so its kernels
run their plain versions).  Everything a client or operator can observe
must be equal — JSON bodies, ``ExecStats``, ``CacheStats``,
``SchedulerStats``, ``CacheInfo``, EXPLAIN trees — with only the timing
fields removed and session ids (a process counter) normalised.  Counts are
integers and scores are float64 from integer counts, so equality is exact.
Each test also keeps the JAX test's own invariants, asserted on the port.

The helpers here (:data:`JAX`, :data:`TORCH`, :func:`both`, :func:`plain`)
serve the other ``test_torch_*`` service mirrors as well.
"""

import base64
import dataclasses
import importlib
import json
import re
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks

_MODULES = {"core": "core", "engine": "core.engine",
            "queries": "core.queries", "plan": "core.plan",
            "store": "core.store", "service": "service",
            "server": "service.server", "asyncserver": "service.asyncserver",
            "admission": "service.admission", "errors": "service.errors",
            "routes": "service.routes", "planner": "service.planner",
            "scheduler": "service.scheduler", "obs": "obs",
            "explain": "obs.explain", "trace": "obs.trace",
            "metrics": "obs.metrics", "lockcheck": "lockcheck"}


def _package(name: str, **dev) -> SimpleNamespace:
    """One package's modules under common names; ``dev`` is what every
    store constructor of that package takes (the port's stores go on the
    CPU)."""
    mods = {k: importlib.import_module(f"{name}.{v}")
            for k, v in _MODULES.items()}
    return SimpleNamespace(name=name, dev=dev, **mods)


JAX = _package("repro")
TORCH = _package("repro_torch", device="cpu")

# Keys whose values are wall-clock readings (a shed's retry_after is a
# token bucket's refill wait): removed before comparing.
_TIME_KEYS = {"uptime_s", "age_s", "idle_s", "bounds_s", "verify_s", "dur_s",
              "time_s", "sum_s", "p50", "p95", "p99", "ts", "dur",
              "retry_after"}
_SID = re.compile(r"s\d+-[0-9a-f]{4}")
_TIMED_TEXT = re.compile(r"(\w*time_s)=[^\s\]]+")


def _text(s: str) -> str:
    """Session ids (``s<counter>-<hex>``) and cursors made comparable; the
    timings of a rendered EXPLAIN tree blanked."""
    if s.startswith("c1."):
        raw = s[3:]
        obj = json.loads(base64.urlsafe_b64decode(raw + "=" * (-len(raw) % 4)))
        return f"cursor({_SID.sub('<sid>', obj['s'])}, {obj['o']})"
    return _TIMED_TEXT.sub(r"\1=<t>", _SID.sub("<sid>", s))


def plain(x):
    """``x`` as plain comparable data, timing fields removed; query ids are
    a tracer's counter (the process-wide tracer's, for a query traced
    outside a service), so only their presence is compared."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = dataclasses.asdict(x)
    if isinstance(x, dict):
        return {plain(k): "<qid>" if k == "query_id" else plain(v)
                for k, v in x.items()
                if not (isinstance(k, str) and
                        (k in _TIME_KEYS or k.endswith("_time_s")))}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, BaseException):
        return [type(x).__name__, _text(str(x))]
    if isinstance(x, str):
        return _text(x)
    return x


def both(scenario):
    """Run ``scenario(P)`` on the JAX package and on the port; require equal
    observables and return the port's."""
    want = scenario(JAX)
    got = scenario(TORCH)
    assert plain(got) == plain(want)
    return got


def raises(fn) -> BaseException:
    """The exception ``fn()`` raises (it must raise)."""
    try:
        fn()
    except Exception as e:      # noqa: BLE001 — compared across packages
        return e
    pytest.fail("expected an exception")


def create_memory(P, masks, meta, cfg: dict, **kw):
    return P.core.MaskStore.create_memory(masks, meta, P.core.CHIConfig(**cfg),
                                          **kw, **P.dev)


def synthetic(P, n, size):
    """The servers' own synthetic store (``server._synthetic_store``)."""
    return P.server._synthetic_store(n, size, **P.dev)


def serve_http(P, service):
    """The threaded HTTP front on port 0 → (httpd, base url)."""
    httpd = P.server.make_server(service, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    host, port = httpd.server_address[:2]
    return httpd, f"http://{host}:{port}"


def metric_names(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


# -- the mirrored tests/test_service.py --------------------------------------

B, H, W = 60, 64, 64

TOPK_SQL = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
            "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 5;")
FILTERED_TOPK_SQL = (
    "SELECT mask_id FROM MasksDatabaseView WHERE "
    "CP(mask, full_img, (0.5, 1.0)) > 200 "
    "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 5;")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The same 60-mask disk database written by each package."""
    rois = object_boxes(B, H, W, seed=2)
    masks, _ = saliency_masks(B, H, W, seed=1, attacked_fraction=0.25,
                              boxes=rois)
    meta = np.zeros(B, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(B) + 1000
    meta["image_id"] = np.arange(B) // 2
    meta["mask_type"] = np.arange(B) % 2 + 1
    roots = {}
    for P in (JAX, TORCH):
        root = str(tmp_path_factory.mktemp(f"servicedb_{P.name}"))
        P.core.MaskStore.create_disk(
            root, masks, meta, P.core.CHIConfig(grid=8, num_bins=16,
                                                height=H, width=W), **P.dev)
        roots[P.name] = root
    return roots, rois


def _open(P, db):
    return P.core.MaskStore.open_disk(db[0][P.name], **P.dev)


def _fresh(P, db, rois=None, **kw):
    return P.service.MaskSearchService(_open(P, db), provided_rois=rois, **kw)


def test_session_pagination_matches_oneshot(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        first = svc.query(TOPK_SQL, session=True, page_size=5)
        pages = [first] + [svc.next_page(first["session"]) for _ in range(3)]
        plan = P.queries.parse(TOPK_SQL)
        ref = P.engine.topk_query(_open(P, db), plan.expr, 20, desc=plan.desc)
        return pages, ref, svc.stats()
    pages, (ids, scores, _), _ = both(scenario)
    assert [p["page"]["offset"] for p in pages] == [0, 5, 10, 15]
    assert sum((p["page"]["ids"] for p in pages), []) == ids.tolist()
    assert sum((p["page"]["scores"] for p in pages), []) == scores.tolist()


def test_pagination_matches_oneshot_with_tied_scores():
    b, h, w = 40, 32, 32
    base = saliency_masks(4, h, w, seed=9)[0]
    masks = base[np.arange(b) % 4]           # 4 patterns: heavy ties
    meta = np.zeros(b, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(b)
    meta["image_id"] = np.arange(b)
    cfg = dict(grid=4, num_bins=8, height=h, width=w)
    sql = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
           "CP(mask, full_img, (0.3, 0.7)) DESC LIMIT 5;")

    def scenario(P):
        svc = P.service.MaskSearchService(create_memory(P, masks, meta, cfg),
                                          verify_batch=4)
        first = svc.query(sql, session=True, page_size=5)
        pages = [first] + [svc.next_page(first["session"]) for _ in range(3)]
        ref = P.engine.topk_query(create_memory(P, masks, meta, cfg),
                                  P.queries.parse(sql).expr, 20, desc=True)
        return pages, ref
    pages, (ids, _, _) = both(scenario)
    paged = sum((p["page"]["ids"] for p in pages), [])
    assert paged == ids.tolist() and len(set(paged)) == 20


def test_pagination_is_incremental_not_rerun(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        first = svc.query(TOPK_SQL, session=True, page_size=5)
        page2 = svc.next_page(first["session"])
        _, _, full = P.engine.topk_query(
            _open(P, db), P.queries.parse(TOPK_SQL).expr, 10, desc=True)
        return first, page2, full
    first, page2, full = both(scenario)
    assert (page2["stats"]["n_verified"] - first["stats"]["n_verified"]
            < full.n_verified)


def test_warm_result_cache_zero_mask_loads(db):
    def scenario(P):
        svc = _fresh(P, db)
        cold = svc.query(TOPK_SQL)
        io0 = svc.store.io.bytes_read
        warm = svc.query(TOPK_SQL)
        loads = svc.store.io.bytes_read - io0
        warm["ids"].reverse()                # caller mutation: no poison
        cold["ids"].clear()
        again = svc.query(TOPK_SQL)
        return cold, warm, loads, again, svc.stats()
    _, warm, loads, again, _ = both(scenario)
    assert warm["cache_hit"] and warm["stats"]["bytes_loaded"] == 0
    assert loads == 0
    assert again["cache_hit"] and again["ids"] == warm["ids"][::-1]


def test_bounds_cache_reused_across_thresholds(db):
    base = ("SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, full_img, (0.2, 0.6)) > {};")

    def scenario(P):
        svc = _fresh(P, db)
        svc.query(base.format(500))
        info0 = dataclasses.replace(svc.planner.bounds_cache.info)
        out = svc.query(base.format(800))
        plan = P.queries.parse(base.format(800))
        ref, _ = P.engine.filter_query(_open(P, db), plan.expr, plan.op,
                                       plan.threshold)
        return info0, svc.planner.bounds_cache.info, out, ref
    info0, info, out, ref = both(scenario)
    assert info0.misses == 1 and info.hits >= 1
    assert sorted(out["ids"]) == sorted(ref.tolist())


def test_fused_batch_loads_fewer_bytes_than_serial(db):
    sqls = ["SELECT mask_id FROM MasksDatabaseView ORDER BY "
            f"CP(mask, full_img, ({lv}, {lv + 0.4})) DESC LIMIT 15;"
            for lv in (0.2, 0.25, 0.3)]

    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        io0 = svc.store.io.bytes_read
        fused = svc.submit_batch(sqls)
        fused_bytes = svc.store.io.bytes_read - io0
        serial_store = _open(P, db)
        io0 = serial_store.io.bytes_read
        serial = [P.queries.parse(s).run(serial_store) for s in sqls]
        return (fused, fused_bytes, serial,
                serial_store.io.bytes_read - io0, svc.stats())
    fused, fused_bytes, serial, serial_bytes, stats = both(scenario)
    assert stats["scheduler"]["fused_passes"] > 0
    assert stats["shared_cache"]["bytes_saved"] > 0
    assert fused_bytes < serial_bytes
    for got, ((ids, scores), _) in zip(fused, serial):
        assert got["ids"] == ids.tolist() and got["scores"] == scores.tolist()


def test_concurrent_session_pages_fused(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        sids = [svc.query("SELECT mask_id FROM MasksDatabaseView ORDER BY "
                          f"CP(mask, full_img, ({lv}, {lv + 0.4})) DESC "
                          "LIMIT 5;", session=True, page_size=5)["session"]
                for lv in (0.2, 0.25)]
        passes0 = svc.scheduler.stats.fused_passes
        pages = svc.next_pages({sid: None for sid in sids})
        return sids, passes0, [pages[s] for s in sids], svc.scheduler.stats
    _, passes0, pages, stats = both(scenario)
    for page in pages:
        assert page["page"]["offset"] == 5 and len(page["page"]["ids"]) == 5
    assert stats.fused_passes >= passes0


def test_filter_and_scalar_through_service(db):
    fsql = ("SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.05;")
    ssql = ("SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.5, 1.0))) "
            "FROM MasksDatabaseView;")
    rois = db[1]

    def scenario(P):
        svc = _fresh(P, db, rois)
        got_f = svc.query(fsql)
        plan = P.queries.parse(fsql)
        store = _open(P, db)
        want_f, _ = P.engine.filter_query(store, plan.expr, plan.op,
                                          plan.threshold, provided_rois=rois)
        got_s = svc.query(ssql)
        want_s, _ = P.engine.scalar_agg(store, P.queries.parse(ssql).expr,
                                        "AVG")
        return got_f, want_f, got_s, want_s, svc.query(ssql)
    got_f, want_f, got_s, want_s, warm = both(scenario)
    assert sorted(got_f["ids"]) == sorted(want_f.tolist())
    assert got_s["value"] == want_s
    assert warm["cache_hit"] and warm["value"] == got_s["value"]


def test_filtered_topk_session_pagination(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        first = svc.query(FILTERED_TOPK_SQL, session=True, page_size=5)
        pages = [first] + [svc.next_page(first["session"]) for _ in range(2)]
        plan = P.queries.parse(FILTERED_TOPK_SQL).plan
        ref = P.plan.run_plan(_open(P, db), dataclasses.replace(plan, k=15))
        return pages, ref
    pages, ((ids, scores), _) = both(scenario)
    assert sum((p["page"]["ids"] for p in pages), []) == ids.tolist()
    assert sum((p["page"]["scores"] for p in pages), []) == scores.tolist()


def test_filtered_topk_fuses_in_batch(db):
    sqls = [FILTERED_TOPK_SQL, FILTERED_TOPK_SQL.replace("0.2", "0.25"),
            "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.3, 0.7))) "
            "FROM MasksDatabaseView;"]

    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        out = svc.submit_batch(sqls)
        store = _open(P, db)
        return out, [P.queries.parse(s).run(store) for s in sqls], \
            svc.scheduler.stats
    out, refs, stats = both(scenario)
    assert stats.fused_passes > 0
    for got, (want, _) in zip(out, refs):
        if got["kind"] == "scalar_agg":
            assert got["value"] == want
        else:
            assert got["ids"] == want[0].tolist()
            assert got["scores"] == want[1].tolist()


def test_service_honors_query_field_mutation(db):
    def scenario(P):
        svc = _fresh(P, db)
        q = P.queries.parse("SELECT mask_id FROM MasksDatabaseView WHERE "
                            "CP(mask, full_img, (0.2, 0.6)) > 500;")
        q.threshold = 900.0
        got = svc.query(q)
        want, _ = P.engine.filter_query(_open(P, db), P.queries.parse(
            "SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, full_img, (0.2, 0.6)) > 900;").predicate)
        return got, want
    got, want = both(scenario)
    assert sorted(got["ids"]) == sorted(want.tolist())


def test_empty_scalar_agg_serves_json_null(db):
    def scenario(P):
        return _fresh(P, db).query(
            "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.2, 0.6))) "
            "FROM MasksDatabaseView WHERE mask_type IN (7);")
    out = both(scenario)
    assert out["value"] is None
    json.loads(json.dumps(out, allow_nan=False))     # strict round-trip


def test_filtered_session_exhausts_when_predicate_starves(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        first = svc.query(
            "SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, full_img, (0.99, 1.0)) > 100000 "      # > area
            "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 5;",
            session=True, page_size=5)
        again = svc.next_page(first["session"])
        n_match = len(P.queries.parse(
            "SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, full_img, (0.5, 1.0)) > 900;").run(_open(P, db))[0])
        page = svc.query(
            "SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, full_img, (0.5, 1.0)) > 900 "
            "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT "
            f"{n_match + 3};", session=True, page_size=n_match + 3)
        return first, again, n_match, page
    first, again, n_match, page = both(scenario)
    assert first["page"]["ids"] == [] and first["exhausted"]
    assert again["page"]["ids"] == [] and again["exhausted"]
    assert 0 < n_match < B
    assert len(page["page"]["ids"]) == n_match and page["exhausted"]


def test_bounds_cache_shared_across_plan_shapes(db):
    def scenario(P):
        svc = _fresh(P, db)
        svc.query("SELECT mask_id FROM MasksDatabaseView WHERE "
                  "CP(mask, full_img, (0.2, 0.6)) > 500;")
        misses0 = svc.planner.bounds_cache.info.misses
        svc.query("SELECT mask_id FROM MasksDatabaseView WHERE "
                  "CP(mask, full_img, (0.2, 0.6)) > 800 "
                  "AND CP(mask, full_img, (0.5, 1.0)) > 10;")
        return misses0, svc.planner.bounds_cache.info
    misses0, info = both(scenario)
    assert info.hits >= 1 and info.misses == misses0 + 1


def test_group_query_through_batch_fallback(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        out = svc.submit_batch([P.queries.SCENARIO3_IOU])
        ref = P.queries.run(P.queries.SCENARIO3_IOU, _open(P, db))
        return out, ref, svc.scheduler.stats
    out, ((ids, scores), _), stats = both(scenario)
    assert out[0]["ids"] == ids.tolist()
    assert out[0]["scores"] == scores.tolist()
    assert stats.fallback_batches > 0                # MASK_AGG can't fuse


@pytest.mark.parametrize("backend", ["device", "mesh"])
def test_service_on_alternate_backends(db, backend):
    """The device- and mesh-backend services answer as the host service
    and load no metered bytes (both read the store's resident rows); on the
    JAX side the same pair of services runs."""
    rois = db[1]

    def scenario(P):
        host = _fresh(P, db, rois, verify_batch=8)
        alt = _fresh(P, db, rois, verify_batch=8, backend=backend)
        want = host.query(FILTERED_TOPK_SQL)
        io0 = alt.store.io.bytes_read
        got = alt.query(FILTERED_TOPK_SQL)
        loads = alt.store.io.bytes_read - io0
        sqls = [TOPK_SQL, TOPK_SQL.replace("0.2", "0.25")]
        batches = (host.submit_batch(sqls), alt.submit_batch(sqls))
        sess_h = host.query(TOPK_SQL, session=True, page_size=5)
        sess_a = alt.query(TOPK_SQL, session=True, page_size=5)
        pages = (host.next_page(sess_h["session"]),
                 alt.next_page(sess_a["session"]))
        out = (alt.stats(), want, got, loads, batches, sess_h, sess_a, pages)
        host.close()
        alt.close()
        return out
    stats, want, got, loads, batches, sess_h, sess_a, pages = both(scenario)
    assert stats["backend"] == backend
    assert got["ids"] == want["ids"] and got["scores"] == want["scores"]
    assert got["stats"]["n_verified"] == want["stats"]["n_verified"]
    assert loads == 0                   # resident-tier verification
    assert [g["ids"] for g in batches[1]] == [w["ids"] for w in batches[0]]
    assert stats["scheduler"]["fused_passes"] > 0
    assert sess_a["page"]["ids"] == sess_h["page"]["ids"]
    assert pages[1]["page"]["ids"] == pages[0]["page"]["ids"]


def test_session_errors(db):
    def scenario(P):
        svc = _fresh(P, db)
        errs = [raises(lambda: svc.query(
            "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.5, 1.0))) "
            "FROM V;", session=True)),
            raises(lambda: svc.next_page("no-such-session"))]
        r = svc.query(TOPK_SQL, session=True)
        dropped = svc.drop_session(r["session"])
        errs.append(raises(lambda: svc.next_page(r["session"])))
        return errs, dropped
    errs, dropped = both(scenario)
    assert isinstance(errs[0], ValueError) and dropped
    assert isinstance(errs[1], KeyError) and isinstance(errs[2], KeyError)


def test_http_roundtrip(db):
    def scenario(P):
        svc = _fresh(P, db, verify_batch=8)
        httpd, base = serve_http(P, svc)
        try:
            client = P.service.ServiceClient(base, timeout=30)
            out = [client.healthz(), client.query(TOPK_SQL)]
            sess = client.query(TOPK_SQL, session=True, page_size=5)
            out += [sess, client.next_page(sess["session"], k=5),
                    client.drop_session(sess["session"]),
                    client.workload([TOPK_SQL,
                                     TOPK_SQL.replace("0.2", "0.25")]),
                    client.stats()]
            for call in (lambda: client.query("SELECT nonsense FROM V;"),
                         lambda: client.next_page("missing")):
                err = raises(call)
                out.append((type(err).__name__, err.code, err.error_code))
            return out
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.close()
    (health, one, _, page2, dropped, batch, stats,
     bad_sql, missing) = both(scenario)
    assert health["ok"] and one["kind"] == "topk" and len(one["ids"]) == 5
    assert page2["page"]["offset"] == 5 and dropped["dropped"]
    assert len(batch) == 2 and batch[0]["cache_hit"]
    assert stats["queries"]["total"] >= 4
    assert "shared_cache" in stats and "result_cache" in stats
    assert bad_sql == ("ServiceError", 400, "bad_request")
    assert missing == ("ServiceError", 404, "not_found")


# -- port-only checks around the service --------------------------------------


def test_port_service_imports_no_jax_and_no_reference_package():
    """The service and EXPLAIN import neither ``jax`` nor ``repro``."""
    import os
    import subprocess
    import sys
    code = ("import sys; import repro_torch.service, "
            "repro_torch.service.server, repro_torch.service.asyncserver, "
            "repro_torch.obs.explain; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_backend_follows_the_store_device():
    """``backend=None`` resolves by the store's device: the host backend on
    a CPU store (the card's rule is held in ``test_torch_cuda.py``), and the
    service and CLIs inherit it."""
    store, rois = synthetic(TORCH, 16, 16)
    be = TORCH.core.get_backend(store, None)
    assert be.name == "host" and be is TORCH.core.backend.host_backend()
    svc = TORCH.service.MaskSearchService(store, provided_rois=rois)
    assert svc.stats()["backend"] == "host"
    assert TORCH.core.get_backend(store, "device").name == "device"
    # the mesh is named, never the default: it resolves, is cached per
    # store, and an instance passes through
    mesh = TORCH.core.get_backend(store, "mesh")
    assert isinstance(mesh, TORCH.core.MeshBackend)
    assert TORCH.core.get_backend(store, "mesh") is mesh
    assert TORCH.core.get_backend(store, mesh) is mesh
    assert TORCH.core.get_backend(store, None) is be
    with pytest.raises(ValueError):
        TORCH.core.get_backend(store, "gpu-cluster")


def _cli_stats(module, *flags) -> dict:
    """Start a CLI on a 16-mask CPU store and return its ``/stats``."""
    import os
    import subprocess
    import sys
    import urllib.request
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.service.{module}",
         "--synthetic", "16", "--size", "16", "--device", "cpu",
         "--port", "0", *flags], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("masksearch"), line
        url = line.split(" on ")[-1].strip()
        with urllib.request.urlopen(url + "/stats", timeout=60) as resp:
            return json.loads(resp.read())
    finally:
        proc.kill()
        proc.wait(timeout=60)


@pytest.mark.parametrize("module", ("server", "asyncserver"))
def test_cli_backend_follows_the_store_device(module):
    """With no ``--backend``, the CLIs leave the choice to ``get_backend``:
    on a CPU store (``--device cpu``) they serve the host backend."""
    assert _cli_stats(module)["backend"] == "host"


@pytest.mark.parametrize("module", ("server", "asyncserver"))
def test_cli_serves_the_mesh_backend(module):
    """``--backend mesh`` serves from the mesh over the store's devices."""
    assert _cli_stats(module, "--backend", "mesh")["backend"] == "mesh"
