"""PyTorch port: the service under concurrent load with the instrumented
locks on, against the JAX package's contract.

Mirrors ``tests/test_concurrency_stress.py`` case by case.  The two stress
legs (the threaded HTTP server and the async tier, each under concurrent
queries, sessions, scrapes, ingest and delete with ``REPRO_LOCK_CHECK=1``)
race threads on purpose, so they hold the port's service to the JAX
test's invariants — no unhandled status, clean sheds, acyclic locks seen
under contention — rather than to the JAX service's exact bodies.  The
lock-check self-tests run the same calls through both packages'
``lockcheck`` and must give the same outcomes.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_service import JAX, TORCH, both, raises, serve_http, \
    synthetic

TOPK_SQL = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
            "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 5;")
FILTER_SQL = ("SELECT mask_id FROM MasksDatabaseView WHERE "
              "CP(mask, full_img, (0.3, 0.7)) > 150;")


@pytest.fixture()
def lock_checked(monkeypatch):
    monkeypatch.setenv("REPRO_LOCK_CHECK", "1")
    for P in (JAX, TORCH):
        P.lockcheck.reset_diagnostics()
    yield
    for P in (JAX, TORCH):
        P.lockcheck.reset_diagnostics()


def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _run(threads, what):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), f"{what} worker hung"


def test_http_stress_under_lock_check(lock_checked):
    store, rois = synthetic(TORCH, 80, 32)
    service = TORCH.service.MaskSearchService(store, provided_rois=rois)
    httpd, base = serve_http(TORCH, service)
    size = store.cfg.height
    codes: list = []
    codes_lock = threading.Lock()
    stop = threading.Event()

    def note(tag, code):
        with codes_lock:
            codes.append((tag, code))

    def query_loop():
        for i in range(10):
            note("query", _post(base, "/query",
                                {"sql": TOPK_SQL if i % 2 else FILTER_SQL})[0])
            note("stats", _get(base, "/stats"))

    def session_loop():
        for _ in range(4):
            code, body = _post(base, "/query", {"sql": TOPK_SQL,
                                                "session": True,
                                                "page_size": 2})
            note("session", code)
            if code == 200 and body.get("session"):
                # paging may 409 once a mutation outpaces the pinned epoch
                note("page", _get(base,
                                  f"/session/{body['session']}/page?k=2"))

    def ingest_loop():
        rng = np.random.default_rng(7)
        for i in range(6):
            masks = rng.random((2, size, size), np.float32)
            note("ingest", _post(base, "/ingest", {
                "masks": masks.tolist(),
                "mask_ids": [10_000 + 2 * i, 10_001 + 2 * i]})[0])

    def delete_loop():
        for i in range(4):
            note("delete", _post(base, "/delete", {"mask_ids": [i]})[0])

    def metrics_loop():
        while not stop.is_set():
            note("metrics", _get(base, "/metrics"))
            stop.wait(0.01)

    scraper = threading.Thread(target=metrics_loop)
    scraper.start()
    _run([threading.Thread(target=query_loop) for _ in range(4)]
         + [threading.Thread(target=session_loop) for _ in range(2)]
         + [threading.Thread(target=ingest_loop),
            threading.Thread(target=delete_loop)], "stress")
    stop.set()
    scraper.join(timeout=30)
    httpd.shutdown()
    httpd.server_close()
    service.close()

    bad = [(tag, c) for tag, c in codes if c not in (200, 404, 409)]
    assert not bad, f"unhandled responses under stress: {bad}"
    assert sum(1 for tag, c in codes if tag == "query" and c == 200) > 0
    assert sum(1 for tag, c in codes if tag == "ingest" and c == 200) > 0
    edges = TORCH.lockcheck.order_edges()
    assert any("service" in k for k in edges), edges
    # every acknowledged write is in the store
    acked = {tag: sum(1 for t, c in codes if t == tag and c == 200)
             for tag in ("ingest", "delete")}
    assert len(store) == 80 + 2 * acked["ingest"] - acked["delete"]


def test_async_tier_stress_under_lock_check(lock_checked):
    store, rois = synthetic(TORCH, 80, 32)
    service = TORCH.service.MaskSearchService(store, provided_rois=rois)
    handle = TORCH.asyncserver.serve_in_thread(
        service, tenant_rate=50.0, tenant_burst=20, queue_depth=64,
        batch_max=16)
    base = handle.base_url
    size = store.cfg.height
    codes: list = []
    codes_lock = threading.Lock()
    shed_envelopes: list = []

    def note(tag, code):
        with codes_lock:
            codes.append((tag, code))

    def call(tag, method, path, body=None, tenant="default"):
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"} if data else {}
        headers["X-Tenant"] = tenant
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                note(tag, resp.status)
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            note(tag, e.code)
            if e.code == 429:
                env = json.loads(e.read())
                with codes_lock:
                    shed_envelopes.append(env)
            return None

    def query_loop(tenant):
        for i in range(8):
            call("query", "POST", "/v1/query",
                 {"sql": TOPK_SQL if i % 2 else FILTER_SQL}, tenant=tenant)

    def session_loop(tenant):
        for _ in range(3):
            out = call("session", "POST", "/v1/query",
                       {"sql": TOPK_SQL, "session": True, "page_size": 2},
                       tenant=tenant)
            if out and out.get("cursor"):
                call("page", "POST", "/v1/page", {"cursor": out["cursor"]},
                     tenant=tenant)

    def ingest_loop():
        rng = np.random.default_rng(11)
        for i in range(5):
            call("ingest", "POST", "/v1/ingest",
                 {"masks": rng.random((2, size, size), np.float32).tolist(),
                  "mask_ids": [20_000 + 2 * i, 20_001 + 2 * i]},
                 tenant="writer")

    def delete_loop():
        for i in range(4):
            call("delete", "POST", "/v1/delete", {"mask_ids": [i]},
                 tenant="writer")

    def greedy_loop():
        for _ in range(60):
            call("greedy", "POST", "/v1/query", {"sql": TOPK_SQL},
                 tenant="greedy")

    def metrics_loop():
        for _ in range(10):
            call("metrics", "GET", "/v1/healthz")

    _run([threading.Thread(target=query_loop, args=(f"t{i}",))
          for i in range(4)]
         + [threading.Thread(target=session_loop, args=(f"t{i}",))
            for i in range(2)]
         + [threading.Thread(target=ingest_loop),
            threading.Thread(target=delete_loop),
            threading.Thread(target=greedy_loop),
            threading.Thread(target=metrics_loop)], "async stress")
    handle.stop()
    service.close()

    bad = [(tag, c) for tag, c in codes if c not in (200, 404, 409, 429)]
    assert not bad, f"unhandled responses under async stress: {bad}"
    assert sum(1 for tag, c in codes if tag == "query" and c == 200) > 0
    assert sum(1 for tag, c in codes if tag == "ingest" and c == 200) > 0
    assert shed_envelopes, "greedy tenant was never rate-limited"
    for env in shed_envelopes:
        err = env["error"]
        assert err["code"] in ("rate_limited", "overloaded")
        assert err["retry_after"] > 0
    polite_ok = sum(1 for tag, c in codes if tag == "query" and c == 200)
    assert polite_ok >= 16, f"polite tenants starved: {polite_ok}"
    edges = TORCH.lockcheck.order_edges()
    assert any("service" in k for k in edges), edges


def test_lock_check_detects_injected_unlocked_write(lock_checked):
    def scenario(P):
        store, rois = synthetic(P, 16, 16)
        service = P.service.MaskSearchService(store, provided_rois=rois)
        err = raises(lambda: service._counts.__setitem__("total", 999))
        with service._lock:
            service._counts["total"] += 1       # locked write is fine
        service.close()
        return type(err).__name__, service._counts["total"]
    assert both(scenario) == ("LockCheckError", 1)


def test_release_by_non_owner_raises(lock_checked):
    def scenario(P):
        lock = P.lockcheck.make_lock("t.nonowner")
        lock.acquire()
        err: list = []

        def rogue():
            try:
                lock.release()
            except P.lockcheck.LockCheckError as e:
                err.append(e)
        t = threading.Thread(target=rogue)
        t.start()
        t.join(timeout=30)
        lock.release()
        # the messages name thread idents, which differ between runs
        return [type(e).__name__ for e in err]
    assert both(scenario) == ["LockCheckError"], \
        "release by a non-owner must raise"


def test_non_reentrant_self_deadlock_raises(lock_checked):
    def scenario(P):
        lock = P.lockcheck.make_lock("t.selfdead")
        with lock:
            return type(raises(lock.acquire)).__name__
    assert both(scenario) == "LockCheckError"


def test_rlock_reentry_allowed(lock_checked):
    def scenario(P):
        lock = P.lockcheck.make_rlock("t.reentrant")
        with lock:
            with lock:
                lock.assert_held()
        return lock.locked()
    assert both(scenario) is False


def test_lock_order_cycle_detected(lock_checked):
    def scenario(P):
        a = P.lockcheck.make_lock("t.order.a")
        b = P.lockcheck.make_lock("t.order.b")
        with a:
            with b:       # records a -> b
                pass
        with b:
            return type(raises(a.acquire)).__name__  # b -> a: a cycle
    assert both(scenario) == "LockCheckError"


def test_hold_time_recorded(lock_checked):
    def scenario(P):
        lock = P.lockcheck.make_lock("t.hold")
        with lock:
            pass
        return P.lockcheck.hold_stats().get("t.hold", -1.0) >= 0.0
    assert both(scenario) is True


def test_disabled_mode_is_plain_threading(monkeypatch):
    monkeypatch.delenv("REPRO_LOCK_CHECK", raising=False)

    def scenario(P):
        lock = P.lockcheck.make_lock("t.plain")
        d = P.lockcheck.guard_dict({"x": 1}, lock)
        d["x"] = 2                 # plain dict: no guard, no error
        return isinstance(lock, type(threading.Lock())), type(d) is dict, d
    assert both(scenario) == (True, True, {"x": 2})
