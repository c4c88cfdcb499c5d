"""PyTorch port: the /v1 API contract against the JAX service.

Mirrors ``tests/test_api_contract.py`` case by case: every request goes to
the JAX server and to the port's, each over its own 60-mask synthetic
store (the port's on the CPU), and the status codes and JSON bodies must
be equal with timing fields removed and session ids normalised
(``test_torch_service.plain``).  The JAX test's schemas and invariants are
kept (imported from it) and asserted on the port's responses.
"""

import json
import urllib.error
import urllib.request

import pytest

from test_api_contract import (DELETE_SCHEMA, ERROR_SCHEMA, INGEST_SCHEMA,
                               ONESHOT_SCHEMA, PAGE_SCHEMA, check_schema)
from test_torch_service import JAX, TORCH, both, plain, raises, serve_http, \
    synthetic

TOPK_SQL = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
            "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 6;")
FILTER_SQL = ("SELECT mask_id FROM MasksDatabaseView WHERE "
              "CP(mask, full_img, (0.3, 0.7)) > 150;")
AGG_SQL = ("SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.3, 0.7))) "
           "FROM MasksDatabaseView;")


@pytest.fixture(scope="module")
def served():
    """Package name → (service, base url): one threaded server each."""
    out, fronts = {}, []
    for P in (JAX, TORCH):
        store, rois = synthetic(P, 60, 32)
        service = P.service.MaskSearchService(store, provided_rois=rois)
        httpd, base = serve_http(P, service)
        out[P.name] = (service, base)
        fronts.append((httpd, service))
    yield out
    for httpd, service in fronts:
        httpd.shutdown()
        httpd.server_close()
        service.close()


def _raw(base, method, path, body=None):
    """→ (status, parsed json) with no client-side shaping."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def over_http(served, scenario):
    """``scenario(call)`` once against each server, where ``call(method,
    path, body)`` is ``_raw`` on that server; the observables must be
    equal.  Returns the port's."""
    got = {name: scenario(lambda m, p, b=None, base=base: _raw(base, m, p, b))
           for name, (_, base) in served.items()}
    assert plain(got[TORCH.name]) == plain(got[JAX.name])
    return got[TORCH.name]


def test_cursor_roundtrip():
    def scenario(P):
        cur = P.routes.encode_cursor("s17-abcd", 25)
        return (cur, P.routes.decode_cursor(cur),
                P.routes.decode_cursor("bare-legacy-sid"),
                raises(lambda: P.routes.decode_cursor("c1.!!!not-base64!!!")),
                raises(lambda: P.routes.decode_cursor("")))
    cur, sid, bare, bad, empty = both(scenario)
    assert cur.startswith("c1.") and "=" not in cur
    assert cur == JAX.routes.encode_cursor("s17-abcd", 25)   # byte-equal
    assert (sid, bare) == ("s17-abcd", "bare-legacy-sid")
    assert isinstance(bad, TORCH.errors.BadCursorError)
    assert isinstance(empty, TORCH.errors.BadCursorError)


def test_v1_query_oneshot_schema(served):
    code, out = over_http(served, lambda call: call(
        "POST", "/v1/query", {"sql": TOPK_SQL}))
    assert code == 200
    check_schema(out, ONESHOT_SCHEMA)
    assert "ids" in out and "scores" in out


def test_v1_session_paging_schema_and_cursor_chain(served):
    def scenario(call):
        replies = [call("POST", "/v1/query",
                        {"sql": TOPK_SQL, "session": True, "page_size": 2})]
        for _ in range(40):                  # page to exhaustion
            code, out = replies[-1]
            if code != 200 or out["exhausted"]:
                break
            replies.append(call("POST", "/v1/page",
                                {"cursor": out["cursor"]}))
        return replies
    replies = over_http(served, scenario)
    assert replies[0][1]["cursor"].startswith("c1.")
    seen = []
    for code, out in replies:
        assert code == 200
        check_schema(out, PAGE_SCHEMA)
        seen += [it["id"] for it in out["items"]]
    assert replies[-1][1]["exhausted"] and replies[-1][1]["cursor"] is None
    assert len(seen) == len(set(seen)), "pages overlapped"


def test_v1_workload_schema(served):
    code, out = over_http(served, lambda call: call(
        "POST", "/v1/workload", {"sqls": [TOPK_SQL, FILTER_SQL, AGG_SQL]}))
    assert code == 200 and len(out["items"]) == 3
    for item in out["items"]:
        check_schema(item, ONESHOT_SCHEMA)


def test_v1_mutation_envelopes(served):
    size = 32
    masks = [[[0.5] * size] * size for _ in range(2)]
    (ci, ing), (cd, dele) = over_http(served, lambda call: [
        call("POST", "/v1/ingest", {"masks": masks,
                                    "mask_ids": [7000, 7001],
                                    "image_ids": [7000, 7001]}),
        call("POST", "/v1/delete", {"mask_ids": [7000, 7001]})])
    assert ci == 200 and cd == 200
    check_schema(ing, INGEST_SCHEMA)
    check_schema(dele, DELETE_SCHEMA)
    assert ing["applied"]["appended"] == 2
    assert dele["applied"]["deleted"] == 2


def test_v1_error_envelopes(served):
    replies = over_http(served, lambda call: [
        call("POST", "/v1/query", {}),
        call("POST", "/v1/query", {"sql": "SELEC nope"}),
        call("POST", "/v1/page", {"cursor": "c1.@@@"}),
        call("POST", "/v1/page", {"cursor": "never-created"}),
        call("POST", "/v1/nope", {})])
    want = [(400, "bad_request"), (400, "bad_request"), (400, "bad_cursor"),
            (404, "not_found"), (404, "not_found")]
    for (code, out), (status, err_code) in zip(replies, want):
        check_schema(out, ERROR_SCHEMA)
        assert (code, out["error"]["code"]) == (status, err_code)


def test_v1_session_drop(served):
    def scenario(call):
        _, out = call("POST", "/v1/query",
                      {"sql": TOPK_SQL, "session": True, "page_size": 2})
        return [call("POST", "/v1/session/drop", {"cursor": out["cursor"]})
                for _ in range(2)]
    first, second = over_http(served, scenario)
    assert first == (200, {"dropped": True})
    assert second[1] == {"dropped": False}       # idempotent


def test_v1_observability_routes(served):
    health, stats, explain, trace = over_http(served, lambda call: [
        call("GET", "/v1/healthz"), call("GET", "/v1/stats"),
        call("POST", "/v1/query", {"sql": "EXPLAIN ANALYZE " + TOPK_SQL}),
        call("GET", "/v1/trace/last")])
    assert health[1] == {"ok": True}
    assert stats[0] == 200 and "epoch" in stats[1]
    assert explain[0] == 200 and explain[1].get("explain")
    assert trace[0] == 200 and trace[1].get("name") == "query"


def test_legacy_routes_byte_identical_to_history(served):
    def scenario(call):
        out = [call("POST", "/query", {"sql": TOPK_SQL})]
        code, legacy = call("POST", "/query", {"sql": TOPK_SQL,
                                               "session": True,
                                               "page_size": 3})
        out += [(code, legacy),
                call("GET", f"/session/{legacy['session']}/page?k=3"),
                call("POST", "/v1/query", {"sql": TOPK_SQL, "session": True,
                                           "page_size": 3}),
                call("POST", "/ingest", {"masks": [[[0.25] * 32] * 32],
                                         "mask_ids": [7100],
                                         "image_ids": [7100]}),
                call("POST", "/delete", {"mask_ids": [7100]}),
                call("POST", "/query", {})]
        return out
    (one, sess, page, v1, ing, dele, err) = over_http(served, scenario)
    assert one[0] == 200 and "items" not in one[1]
    for key in ("kind", "ids", "scores", "stats", "cache_hit"):
        assert key in one[1]
    assert sess[0] == 200 and "cursor" not in sess[1]
    for key in ("session", "page", "served", "exhausted"):
        assert key in sess[1]
    assert not sess[1]["session"].startswith("c1.")     # bare sid
    assert page[0] == 200 and page[1]["page"]["offset"] == 3
    assert [it["id"] for it in v1[1]["items"]] == sess[1]["page"]["ids"]
    assert [it["score"] for it in v1[1]["items"]] == \
        sess[1]["page"]["scores"]
    assert ing[0] == 200 and "applied" not in ing[1]
    for key in ("epoch", "appended", "updated", "n_masks"):
        assert key in ing[1]
    assert dele[0] == 200 and "deleted" in dele[1]
    assert err[0] == 400 and isinstance(err[1]["error"], str)


def test_client_speaks_v1_but_returns_legacy_shapes(served):
    def scenario(P):
        c = P.service.ServiceClient(served[P.name][1], timeout=30)
        r = c.query(TOPK_SQL, session=True, page_size=2)
        r2 = c.next_page(r["session"])
        dropped = c.drop_session(r2["session"] or r["session"])
        err = raises(lambda: c.query("SELEC nope"))
        return r, r2, dropped, (err.code, err.error_code, err.error_type)
    r, r2, dropped, err = both(scenario)
    assert r["session"].startswith("c1.")   # cursor rides the session field
    assert r2["page"]["offset"] == 2 and dropped["dropped"]
    assert err[:2] == (400, "bad_request") and err[2]


def test_genuine_keyerror_is_500_not_404(served):
    def boom(*a, **kw):
        raise KeyError("some internal dict key")
    originals = {}
    for service, _ in served.values():
        originals[id(service)] = service.next_page
        service.next_page = boom
    try:
        v1, legacy = over_http(served, lambda call: [
            call("POST", "/v1/page", {"cursor": "whatever-sid"}),
            call("GET", "/session/whatever-sid/page")])
    finally:
        for service, _ in served.values():
            service.next_page = originals[id(service)]
    assert v1[0] == 500
    check_schema(v1[1], ERROR_SCHEMA)
    assert (v1[1]["error"]["code"], v1[1]["error"]["type"]) == \
        ("internal", "KeyError")
    assert legacy[0] == 500 and isinstance(legacy[1]["error"], str)


def test_notfounderror_maps_to_404():
    def scenario(P):
        return (P.errors.error_envelope(P.errors.NotFoundError("nope")),
                str(P.errors.NotFoundError("bare message")),
                P.errors.error_envelope(KeyError("k")))
    (status, env, _), msg, (kstatus, kenv, _) = both(scenario)
    assert (status, env["error"]["code"]) == (404, "not_found")
    assert msg == "bare message"
    assert (kstatus, kenv["error"]["code"]) == (500, "internal")
