"""Thin stdlib HTTP/JSON front for :class:`MaskSearchService`.

Two route namespaces share one service:

* ``/v1/...`` — the versioned API (DESIGN.md §14): structured error
  envelopes ``{"error": {"code", "type", "message", "retry_after"?}}``,
  ``{"epoch", "applied", ...}`` mutation responses, and opaque
  continuation cursors for session paging (``POST /v1/page`` with
  ``{"cursor": ...}`` → ``{"cursor"|null, "items", "exhausted", ...}``).
  The route core lives in :mod:`.routes`, shared with the async tier
  (:mod:`.asyncserver`), so the two fronts cannot drift.
* unversioned legacy routes — thin compat shims over the same service
  methods, serving the historical payloads byte-identically.  Deprecated
  in favour of ``/v1`` (see README); they remain until a major rev.

Legacy endpoints (all JSON):

* ``POST /query``    — body ``{"sql": "...", "session": bool?,
  "page_size": int?, "rois": [[r0,c0,r1,c1], ...]?}`` → one result, or the
  first page + ``session`` id.  WHERE clauses compose with AND/OR/NOT and
  with ORDER BY … LIMIT (predicate-filtered rankings paginate too).
* ``POST /workload`` — body ``{"sqls": ["...", ...]}`` → list of results,
  verified in fused cross-query passes.
* ``POST /ingest``   — body ``{"masks": [[[...]]], "mask_ids": [...]?,
  "image_ids": [...]?, "model_ids": int|[...]?, "mask_types": int|[...]?,
  "on_conflict": "error"|"update"}`` → append/upsert masks; CHI rows are
  maintained incrementally and the store epoch advances.
* ``POST /delete``   — body ``{"mask_ids": [...]}`` → remove masks.
* ``GET /session/<id>/page?k=N`` — next page of an open session (409 if
  the session's pinned epoch can no longer be served after a mutation).
* ``DELETE /session/<id>``       — drop a session.
* ``GET /stats``     — cache / I/O / session counters + the store epoch,
  per-session phase breakdowns, and query-phase latency summaries.
* ``GET /metrics``   — the Prometheus text exposition (service registry +
  process-global kernel/jit/backend counters); not JSON.
* ``GET /trace/<query_id>`` — a retained span tree (``<query_id>`` =
  ``last`` → most recent; ``?format=chrome`` → Chrome trace-event JSON,
  loadable in Perfetto).  Traces are retained for every query when the
  server runs with ``--trace``, and always for ``EXPLAIN ANALYZE``.
* ``GET /healthz``   — liveness.

Run it::

    PYTHONPATH=src python -m repro_torch.service.server --synthetic 500 --port 8765
    PYTHONPATH=src python -m repro_torch.service.server --root /path/to/maskdb
"""

from __future__ import annotations

import argparse
import json
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import routes
from .api import MaskSearchService
from .errors import NotFoundError, error_envelope

_SESSION_PAGE_RE = re.compile(r"^/session/([^/]+)/page$")
_SESSION_RE = re.compile(r"^/session/([^/]+)$")
_TRACE_RE = re.compile(r"^(?:/v1)?/trace/([^/]+)$")


class ServiceHandler(BaseHTTPRequestHandler):
    service: MaskSearchService = None  # bound by make_server
    verbose: bool = False

    # -- plumbing ---------------------------------------------------------
    def log_message(self, fmt, *args):  # noqa: N802
        if self.verbose:
            super().log_message(fmt, *args)

    def _send(self, obj, code: int = 200, *,
              retry_after: float | None = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After",
                             str(max(1, int(-(-retry_after // 1)))))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, text: str, code: int = 200,
                   content_type: str = "text/plain; version=0.0.4; "
                                       "charset=utf-8") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send({"error": message}, code)

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def _guard(self, fn, *, v1: bool = False):
        """Run one handler, translating exceptions to HTTP errors.

        ``NotFoundError`` — not bare ``KeyError`` — is what maps to 404:
        a genuine ``KeyError`` escaping from engine internals is a server
        fault and surfaces as the 500 it is, instead of masquerading as
        "not found".  ``/v1`` routes serve the structured error envelope;
        legacy routes keep their historical ``{"error": "<str>"}`` body.
        """
        try:
            fn()
        except Exception as e:              # noqa: BLE001 — serving loop
            status, envelope, retry_after = error_envelope(e)
            if v1:
                self._send(envelope, status, retry_after=retry_after)
            else:
                self._error(status, envelope["error"]["message"])

    # -- /v1 routes (shaping shared with the async tier via .routes) ------
    def _post_v1(self, path: str) -> bool:
        if path == "/v1/query":
            def run():
                body = self._body()
                self._send(routes.shape_query(
                    self.service.query(**routes.query_kwargs(body))))
            self._guard(run, v1=True)
            return True
        if path == "/v1/workload":
            def run():
                body = self._body()
                self._send(routes.shape_workload(self.service.submit_batch(
                    routes.workload_sqls(body),
                    rois=routes.parse_rois(body))))
            self._guard(run, v1=True)
            return True
        if path == "/v1/page":
            def run():
                sid, k = routes.page_request(self._body())
                self._send(routes.shape_page(self.service.next_page(sid, k)))
            self._guard(run, v1=True)
            return True
        if path == "/v1/ingest":
            def run():
                self._send(routes.shape_ingest(self.service.ingest(
                    **routes.ingest_kwargs(self._body()))))
            self._guard(run, v1=True)
            return True
        if path == "/v1/delete":
            def run():
                self._send(routes.shape_delete(self.service.delete(
                    routes.delete_ids(self._body()))))
            self._guard(run, v1=True)
            return True
        if path == "/v1/session/drop":
            def run():
                body = self._body()
                if "cursor" not in body:
                    raise ValueError("body must contain 'cursor'")
                sid = routes.decode_cursor(body["cursor"])
                self._send({"dropped": self.service.drop_session(sid)})
            self._guard(run, v1=True)
            return True
        return False

    # -- routes -----------------------------------------------------------
    def do_POST(self):  # noqa: N802
        path = urlparse(self.path).path
        if path.startswith("/v1/"):
            if not self._post_v1(path):
                self._send(error_envelope(
                    NotFoundError(f"no route {path}"))[1], 404)
            return
        if path == "/query":
            def run():
                body = self._body()
                if "sql" not in body:
                    raise ValueError("body must contain 'sql'")
                rois = body.get("rois")
                self._send(self.service.query(
                    body["sql"],
                    rois=np.asarray(rois, np.int64) if rois else None,
                    session=bool(body.get("session", False)),
                    page_size=body.get("page_size")))
            return self._guard(run)
        if path == "/workload":
            def run():
                body = self._body()
                if "sqls" not in body:
                    raise ValueError("body must contain 'sqls'")
                rois = body.get("rois")
                self._send(self.service.submit_batch(
                    body["sqls"],
                    rois=np.asarray(rois, np.int64) if rois else None))
            return self._guard(run)
        if path == "/ingest":
            def run():
                body = self._body()
                if "masks" not in body:
                    raise ValueError("body must contain 'masks'")
                self._send(self.service.ingest(
                    np.asarray(body["masks"], np.float32),
                    mask_ids=body.get("mask_ids"),
                    image_ids=body.get("image_ids"),
                    model_ids=body.get("model_ids"),
                    mask_types=body.get("mask_types"),
                    on_conflict=body.get("on_conflict", "error")))
            return self._guard(run)
        if path == "/delete":
            def run():
                body = self._body()
                if "mask_ids" not in body:
                    raise ValueError("body must contain 'mask_ids'")
                self._send(self.service.delete(body["mask_ids"]))
            return self._guard(run)
        self._error(404, f"no route {path}")

    def do_GET(self):  # noqa: N802
        parsed = urlparse(self.path)
        v1 = parsed.path.startswith("/v1/")
        m = _SESSION_PAGE_RE.match(parsed.path)
        if m:
            sid = m.group(1)

            def run():
                qs = parse_qs(parsed.query)
                try:
                    k = int(qs["k"][0]) if "k" in qs else None
                except ValueError:
                    raise ValueError(f"bad page size k={qs['k'][0]!r}")
                self._send(self.service.next_page(sid, k))
            return self._guard(run)
        m = _TRACE_RE.match(parsed.path)
        if m:
            qid = m.group(1)

            def run():
                qs = parse_qs(parsed.query)
                fmt = (qs.get("format") or ["json"])[0]
                if fmt not in ("json", "chrome"):
                    raise ValueError(f"format must be json|chrome, "
                                     f"got {fmt!r}")
                self._send(self.service.trace(qid, fmt=fmt))
            return self._guard(run, v1=v1)
        if parsed.path in ("/stats", "/v1/stats"):
            return self._guard(lambda: self._send(self.service.stats()),
                               v1=v1)
        if parsed.path in ("/metrics", "/v1/metrics"):
            return self._guard(
                lambda: self._send_text(self.service.metrics_text()), v1=v1)
        if parsed.path in ("/healthz", "/v1/healthz"):
            return self._send({"ok": True})
        if v1:
            return self._send(error_envelope(
                NotFoundError(f"no route {parsed.path}"))[1], 404)
        self._error(404, f"no route {parsed.path}")

    def do_DELETE(self):  # noqa: N802
        m = _SESSION_RE.match(urlparse(self.path).path)
        if m:
            return self._guard(lambda: self._send(
                {"dropped": self.service.drop_session(m.group(1))}))
        self._error(404, "no route")


def make_server(service: MaskSearchService, host: str = "127.0.0.1",
                port: int = 0, *, verbose: bool = False) -> ThreadingHTTPServer:
    """Bind a threading HTTP server to the service (port 0 → ephemeral)."""
    handler = type("BoundServiceHandler", (ServiceHandler,),
                   {"service": service, "verbose": verbose})
    return ThreadingHTTPServer((host, port), handler)


def _synthetic_store(n: int, size: int, device="cuda"):
    from ..core import CHIConfig, MaskStore
    from ..core.store import MASK_META_DTYPE
    from ..data.masks import object_boxes, saliency_masks
    rois = object_boxes(n, size, size, seed=1)
    masks, _ = saliency_masks(n, size, size, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=size, width=size)
    return MaskStore.create_memory(masks, meta, cfg, device=device), rois


def main(argv=None):
    ap = argparse.ArgumentParser(description="MaskSearch query service")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--root", help="existing on-disk mask DB root")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="serve an N-mask synthetic in-memory DB")
    ap.add_argument("--size", type=int, default=128,
                    help="mask side for --synthetic")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--verify-batch", type=int, default=256)
    ap.add_argument("--backend", default=None,
                    choices=("host", "device", "mesh"),
                    help="physical execution layer (core/backend.py): host "
                         "NumPy loads, masks and CHI resident on the "
                         "store's device, or the mesh over every local "
                         "device of the store's type; by default the device "
                         "backend on a cuda store and the host backend on a "
                         "cpu one")
    ap.add_argument("--device", default="cuda",
                    help="torch device the store lives on (cuda, or cpu)")
    ap.add_argument("--trace", action="store_true",
                    help="trace every query (span trees retrievable at "
                         "GET /trace/<query_id>); EXPLAIN ANALYZE traces "
                         "its query regardless")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.root:
        from ..core import MaskStore
        store, rois = MaskStore.open_disk(args.root, device=args.device), None
    else:
        store, rois = _synthetic_store(args.synthetic, args.size,
                                       device=args.device)
    service = MaskSearchService(store, provided_rois=rois,
                                verify_batch=args.verify_batch,
                                backend=args.backend, trace=args.trace)
    httpd = make_server(service, args.host, args.port, verbose=args.verbose)
    host, port = httpd.server_address[:2]
    print(f"masksearch service: {len(store)} masks on http://{host}:{port}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()


if __name__ == "__main__":
    main()
