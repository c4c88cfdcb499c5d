"""PyTorch port: the async serving tier against the JAX tier.

Mirrors ``tests/test_async_tier.py`` case by case.  The admission
primitives get the same calls in both packages and must return the same
values; the HTTP tier runs once per package over its own 60-mask synthetic
store (the port's on the CPU), the same requests go to both, and statuses
and bodies must be equal with timing fields removed
(``test_torch_service.plain``).  Where the JAX test races threads on
purpose (concurrent volleys), the answers are compared, not the batching.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import pytest

from test_torch_service import JAX, TORCH, both, raises, synthetic

TOPK_SQL = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
            "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT {n};")
FILTER_SQL = ("SELECT mask_id FROM MasksDatabaseView WHERE "
              "CP(mask, full_img, (0.3, 0.7)) > {t};")


# -- admission primitives ---------------------------------------------------

def test_token_bucket_grant_and_refill():
    def scenario(P):
        b = P.admission.TokenBucket(rate=1.0, burst=2.0)
        waits = [b.try_take(t) for t in (0.0, 0.0, 0.0, 0.5, 1.6)]
        b2 = P.admission.TokenBucket(rate=10.0, burst=1.0)
        return waits, b2.try_take(0.0), b2.try_take(100.0)
    waits, _, clamped = both(scenario)
    assert waits[:2] == [0.0, 0.0] and waits[2] == pytest.approx(1.0)
    assert waits[3] > 0.0 and waits[4] == 0.0 and clamped == 0.0


def test_fair_queue_depth_bound_and_force():
    def scenario(P):
        q = P.admission.FairQueue(depth=2)
        pushed = [q.push("a", 1), q.push("a", 2), q.push("a", 3),
                  q.push("a", 3, force=True)]
        return pushed, q.depth_of("a"), len(q)
    assert both(scenario) == ([True, True, False, True], 3, 3)


def test_fair_queue_drr_is_weighted_fair():
    def scenario(P):
        q = P.admission.FairQueue(depth=100, weights={"heavy": 2.0})
        for i in range(30):
            q.push("heavy", f"h{i}")
            q.push("light", f"l{i}")
        return q.pop_batch(18), q.pop_batch(10_000), len(q)
    batch, rest, left = both(scenario)
    heavy = sum(1 for t, _ in batch if t == "heavy")
    light = len(batch) - heavy
    assert heavy == pytest.approx(2 * light, abs=2) and light >= 5
    assert len(rest) == 60 - len(batch) and left == 0


def test_fair_queue_single_tenant_fifo_order():
    def scenario(P):
        q = P.admission.FairQueue(depth=10)
        for i in range(5):
            q.push("t", i)
        return [item for _, item in q.pop_batch(5)]
    assert both(scenario) == [0, 1, 2, 3, 4]


def test_admission_controller_sheds_with_retry_after():
    def scenario(P):
        clk = [0.0]
        ac = P.admission.AdmissionController(rate=1.0, burst=2.0, depth=1,
                                             clock=lambda: clk[0])
        ac.admit("t", "job1")
        over = raises(lambda: ac.admit("t", "job2"))    # queue full
        first = ac.queue.pop_batch(10)
        ac.admit("t", "job2")
        second = ac.queue.pop_batch(10)
        rate = raises(lambda: ac.admit("t", "job3"))    # bucket empty
        clk[0] = 1.0
        ac.admit("t", "job3")
        return (type(over).__name__, over.retry_after, first, second,
                type(rate).__name__, rate.retry_after, ac.stats)
    over, over_wait, first, second, rate, rate_wait, stats = both(scenario)
    assert over == "OverloadedError" and over_wait > 0
    assert first == [("t", "job1")] and second == [("t", "job2")]
    assert rate == "RateLimitedError" and rate_wait == pytest.approx(1.0)
    assert (stats.admitted, stats.shed_queue_full,
            stats.shed_rate_limited) == (3, 1, 1)


# -- the HTTP tier ----------------------------------------------------------

def _serve(P, n, **tier_kwargs):
    store, rois = synthetic(P, n, 32)
    service = P.service.MaskSearchService(store, provided_rois=rois)
    return service, P.asyncserver.serve_in_thread(service, **tier_kwargs)


@pytest.fixture(scope="module")
def tier():
    """Package name → (service, handle)."""
    out = {P.name: _serve(P, 60, tenant_rate=10_000, tenant_burst=10_000)
           for P in (JAX, TORCH)}
    yield out
    for service, handle in out.values():
        handle.stop()
        service.close()


def _raw(base, method, path, body=None, tenant=None):
    data = json.dumps(body).encode() if body is not None else None
    headers = {"Content-Type": "application/json"} if data else {}
    if tenant:
        headers["X-Tenant"] = tenant
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def _calls(base, requests):
    """(status, body, whether a Retry-After header of at least 1 s came)
    of each request in turn; the header's value is a token bucket's refill
    wait, a time, so only its floor is compared."""
    out = []
    for req in requests:
        code, body, headers = _raw(base, *req)
        retry = headers.get("Retry-After")
        out.append((code, body, None if retry is None else int(retry) >= 1))
    return out


def test_tier_serves_both_namespaces(tier):
    reqs = [("POST", "/v1/query", {"sql": TOPK_SQL.format(n=5)}),
            ("POST", "/query", {"sql": TOPK_SQL.format(n=5)}),
            ("GET", "/v1/healthz"), ("GET", "/v1/stats"),
            ("POST", "/v1/nope", {}), ("POST", "/query", {})]
    out = both(lambda P: _calls(tier[P.name][1].base_url, reqs))
    (c1, v1, _), (c2, legacy, _), (c3, health, _), (c4, stats, _), \
        (c5, nope, _), (c6, err, _) = out
    assert c1 == 200 and v1["ids"] and c2 == 200 and legacy["ids"] == v1["ids"]
    assert (c3, health) == (200, {"ok": True})
    assert c4 == 200 and "epoch" in stats
    assert c5 == 404 and nope["error"]["code"] == "not_found"
    assert c6 == 400 and isinstance(err["error"], str)     # legacy flat


def test_quota_shed_is_clean_429_with_retry_after():
    sql = TOPK_SQL.format(n=3)
    reqs = [("POST", "/v1/query", {"sql": sql}, "greedy"),
            ("POST", "/v1/query", {"sql": sql}, "greedy"),
            ("POST", "/v1/query", {"sql": sql}, "patient"),
            ("POST", "/v1/delete", {"mask_ids": [0]}, "greedy")]

    def scenario(P):
        service, handle = _serve(P, 40, tenant_rate=0.001, tenant_burst=1)
        try:
            return (_calls(handle.base_url, reqs),
                    handle.tier.admission.stats)
        finally:
            handle.stop()
            service.close()
    (ok, shed, other, shed_delete), stats = both(scenario)
    assert ok[0] == 200 and other[0] == 200     # quota is per tenant
    for code, body, retry in (shed, shed_delete):
        assert code == 429 and body["error"]["code"] == "rate_limited"
        assert body["error"]["retry_after"] > 0 and retry is True
    assert stats.shed_rate_limited >= 2


def test_connection_limit_sheds_overloaded():
    def scenario(P):
        service, handle = _serve(P, 20, max_connections=1)
        try:
            tier = handle.tier
            squatter = socket.create_connection((tier.host, tier.port),
                                                timeout=10)
            try:
                for _ in range(50):
                    if tier.stats.connections_open >= 1:
                        break
                    threading.Event().wait(0.01)
                code, err, headers = _raw(handle.base_url, "GET",
                                          "/v1/healthz")
                return (code, err, "Retry-After" in headers,
                        tier.stats.shed_connections >= 1)
            finally:
                squatter.close()
        finally:
            handle.stop()
            service.close()
    code, err, has_retry, shed = both(scenario)
    assert code == 429 and err["error"]["code"] == "overloaded"
    assert has_retry and shed


def test_streaming_session_matches_oneshot(tier):
    def scenario(P):
        service, handle = tier[P.name]
        c = P.service.ServiceClient(handle.base_url, timeout=30)
        oneshot = c.query(TOPK_SQL.format(n=12))
        pages = list(c.stream_query(TOPK_SQL.format(n=12), page_size=5))
        return (oneshot, pages, handle.tier.stats.stream_pages,
                len(service.sessions))
    oneshot, pages, stream_pages, live = both(scenario)
    assert len(pages) >= 2
    assert pages[-1]["exhausted"] and pages[-1]["cursor"] is None
    streamed = [it["id"] for p in pages for it in p["items"]]
    assert streamed[:len(oneshot["ids"])] == oneshot["ids"]
    assert stream_pages >= len(pages) and live == 0


def test_cross_tenant_fusion_in_one_batch(tier):
    items = [{"op": "query", "sql": TOPK_SQL.format(n=3 + i),
              "tenant": f"tenant-{i % 3}"} for i in range(6)]

    def scenario(P):
        service, _ = tier[P.name]
        before = service.scheduler.stats.cross_tenant_passes
        results = service.execute_many(items)
        names = {n for n in ("masksearch_scheduler_cross_tenant_passes",
                             "repro_async_tier_batches",
                             "repro_admission_admitted")
                 if n in service.metrics_text()}
        return before, results, service.scheduler.stats, sorted(names)
    before, results, stats, names = both(scenario)
    assert all(status == "ok" for status, _ in results)
    assert stats.cross_tenant_passes > before
    assert stats.cross_tenant_jobs >= 2 and stats.fused_tenant_width >= 3
    assert len(names) == 3


def _volley(base) -> dict:
    """6 tenants' filter queries released together → {i: (status, ids)}."""
    barrier = threading.Barrier(6)
    got: dict = {}

    def fire(i):
        barrier.wait()
        code, body, _ = _raw(base, "POST", "/v1/query",
                             {"sql": FILTER_SQL.format(t=120 + i)},
                             tenant=f"t{i}")
        got[i] = (code, body["ids"])
    threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(got) == 6 and all(c == 200 for c, _ in got.values())
    return got


def test_cross_tenant_fusion_over_http(tier):
    """Concurrent volleys from distinct tenants fuse; how a volley splits
    into batches is the scheduler's race, so each package is held to the
    JAX test's property and to the same answers, not the same batches."""
    answers = {}
    for P in (JAX, TORCH):
        service, handle = tier[P.name]
        before = service.scheduler.stats.cross_tenant_passes
        for _ in range(8):
            got = _volley(handle.base_url)
            if service.scheduler.stats.cross_tenant_passes > before:
                break
        assert service.scheduler.stats.cross_tenant_passes > before, \
            f"{P.name}: no cross-tenant fused pass in 8 concurrent volleys"
        assert handle.tier.stats.batches > 0
        answers[P.name] = {i: sorted(ids) for i, (_, ids) in got.items()}
    assert answers[TORCH.name] == answers[JAX.name]


def test_execute_many_isolates_per_item_faults(tier):
    results = both(lambda P: tier[P.name][0].execute_many([
        {"op": "query", "sql": TOPK_SQL.format(n=3)},
        {"op": "query", "sql": "SELEC nope"},
        {"op": "page", "session_id": "never-created"}]))
    assert results[0][0] == "ok"
    assert results[1][0] == "error" and isinstance(results[1][1], Exception)
    assert results[2][0] == "error"
    assert isinstance(results[2][1], KeyError)    # NotFoundError subclass


def test_tier_sessions_and_mutations(tier):
    def scenario(P):
        base = tier[P.name][1].base_url
        code, out, _ = _raw(base, "POST", "/v1/query",
                            {"sql": TOPK_SQL.format(n=6), "session": True,
                             "page_size": 2})
        replies = [(code, out)]
        code, page, _ = _raw(base, "POST", "/v1/page",
                             {"cursor": out["cursor"]})
        replies.append((code, page))
        for req in (("POST", "/v1/ingest", {"masks": [[[0.5] * 32] * 32],
                                            "mask_ids": [8200],
                                            "image_ids": [8200]}),
                    ("POST", "/v1/page", {"cursor": page["cursor"]}),
                    ("POST", "/v1/delete", {"mask_ids": [8200]})):
            code, body, _ = _raw(base, *req)
            replies.append((code, body))
        return replies
    (c0, out), (c1, page), (c2, ing), (c3, after), (c4, dele) = \
        both(scenario)
    assert c0 == 200 and out["cursor"].startswith("c1.")
    assert c1 == 200 and page["offset"] == 2
    assert c2 == 200 and ing["applied"]["appended"] == 1
    # append-only ingest keeps the pinned snapshot serveable, or is a
    # clean 409 stale_epoch envelope — never a 500
    assert c3 in (200, 409)
    if c3 == 409:
        assert after["error"]["code"] == "stale_epoch"
    assert c4 == 200 and dele["applied"]["deleted"] == 1
