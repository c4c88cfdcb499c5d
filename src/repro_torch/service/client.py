"""Stdlib client for the MaskSearch query service, speaking the ``/v1``
API (structured error envelopes, opaque continuation cursors).

Public method signatures are unchanged from the legacy client, and the
dict shapes they return keep the historical layout (``session``/``page``
keys) so existing callers and tests need no edits — the ``session`` value
is now an opaque ``/v1`` continuation cursor rather than a bare session
id (the server accepts either).

Resilience: ``_call`` retries transparently on connection errors and
429 shed responses with jittered exponential backoff, honouring the
server's ``Retry-After``.  Mutations (``ingest``/``delete_masks``) are
**not** retried by default — a timed-out ingest may have applied, and a
blind resend with ``on_conflict="error"`` would double-apply or fault;
opt in with ``retry_mutations=True`` if the workload is idempotent.
"""

from __future__ import annotations

import json
import random
import time
from typing import Optional, Sequence
from urllib import request as _request
from urllib.error import HTTPError, URLError


class ServiceError(RuntimeError):
    """An HTTP error from the service.

    ``code`` is the HTTP status (historical name, kept for
    compatibility); the ``/v1`` envelope's machine-readable fields are
    ``error_code`` (e.g. ``"rate_limited"``), ``error_type`` (the
    server-side exception class) and ``retry_after`` (seconds, when the
    response was a shed)."""

    def __init__(self, code: int, message: str, *,
                 error_code: Optional[str] = None,
                 error_type: Optional[str] = None,
                 retry_after: Optional[float] = None):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        self.error_code = error_code
        self.error_type = error_type
        self.retry_after = retry_after


class ServiceClient:
    def __init__(self, base_url: str, *, timeout: float = 30.0,
                 retries: int = 2, backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 retry_mutations: bool = False):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = max(int(retries), 0)
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.retry_mutations = retry_mutations
        self._rng = random.Random()

    # -- plumbing ---------------------------------------------------------
    def _sleep(self, attempt: int, retry_after: Optional[float]) -> None:
        # full jitter over an exponential ceiling; a server-provided
        # Retry-After is a floor (the shed really is that long)
        ceiling = min(self.backoff_s * (2 ** attempt), self.max_backoff_s)
        delay = ceiling * (0.5 + 0.5 * self._rng.random())
        if retry_after is not None:
            delay = max(delay, float(retry_after))
        time.sleep(delay)

    @staticmethod
    def _error_from(e: HTTPError) -> ServiceError:
        error_code = error_type = retry_after = None
        try:
            body = json.loads(e.read())
            err = body.get("error")
            if isinstance(err, dict):            # /v1 envelope
                message = err.get("message", str(e))
                error_code = err.get("code")
                error_type = err.get("type")
                retry_after = err.get("retry_after")
            else:                                # legacy {"error": "<str>"}
                message = err if err is not None else str(e)
        except Exception:          # noqa: BLE001 — best-effort decode
            message = str(e)
        if retry_after is None:
            header = e.headers.get("Retry-After") if e.headers else None
            if header is not None:
                try:
                    retry_after = float(header)
                except ValueError:
                    pass
        return ServiceError(e.code, message, error_code=error_code,
                            error_type=error_type, retry_after=retry_after)

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              *, raw: bool = False, idempotent: bool = True):
        data = json.dumps(body).encode() if body is not None else None
        retriable = idempotent or self.retry_mutations
        attempt = 0
        while True:
            req = _request.Request(
                self.base_url + path, data=data, method=method,
                headers={"Content-Type": "application/json"} if data else {})
            try:
                with _request.urlopen(req, timeout=self.timeout) as resp:
                    payload = resp.read()
                    return payload.decode() if raw else json.loads(payload)
            except HTTPError as e:
                err = self._error_from(e)
                if e.code == 429 and retriable and attempt < self.retries:
                    self._sleep(attempt, err.retry_after)
                    attempt += 1
                    continue
                raise err from e
            except URLError as e:
                if retriable and attempt < self.retries:
                    self._sleep(attempt, None)
                    attempt += 1
                    continue
                raise

    # -- legacy-shape adapters -------------------------------------------
    @staticmethod
    def _page_compat(payload: dict, fallback_cursor: str = "") -> dict:
        """/v1 cursor-paged payload → the historical session/page layout
        (``session`` carries the continuation cursor)."""
        if "items" not in payload:
            return payload                      # one-shot / explain: as-is
        items = payload["items"]
        out = {
            "kind": payload["kind"],
            "session": payload["cursor"] or fallback_cursor,
            "page": {"offset": payload["offset"],
                     "ids": [it["id"] for it in items],
                     "scores": [it["score"] for it in items]},
            "served": payload["served"],
            "total_candidates": payload["total_candidates"],
            "exhausted": payload["exhausted"],
            "stats": payload["stats"],
            "cache_hit": payload["cache_hit"],
        }
        if "query_id" in payload:
            out["query_id"] = payload["query_id"]
        return out

    # -- API --------------------------------------------------------------
    def query(self, sql: str, *, rois=None, session: bool = False,
              page_size: Optional[int] = None) -> dict:
        body = {"sql": sql, "session": session}
        if page_size is not None:
            body["page_size"] = page_size
        if rois is not None:
            body["rois"] = [[int(v) for v in row] for row in rois]
        return self._page_compat(self._call("POST", "/v1/query", body))

    def workload(self, sqls: Sequence[str], *, rois=None) -> list:
        body = {"sqls": list(sqls)}
        if rois is not None:
            body["rois"] = [[int(v) for v in row] for row in rois]
        return [self._page_compat(p)
                for p in self._call("POST", "/v1/workload", body)["items"]]

    def ingest(self, masks, *, mask_ids=None, image_ids=None, model_ids=None,
               mask_types=None, on_conflict: str = "error") -> dict:
        """Append/upsert masks (nested lists or arrays) into the database.

        Returns the ``/v1`` mutation envelope ``{"epoch", "applied":
        {"appended", "updated"}, ...}`` with the legacy flat counters
        mirrored at top level."""
        body = {"masks": [[[float(v) for v in row] for row in m]
                          for m in masks],
                "on_conflict": on_conflict}
        if mask_ids is not None:
            body["mask_ids"] = [int(x) for x in mask_ids]
        if image_ids is not None:
            body["image_ids"] = [int(x) for x in image_ids]
        if model_ids is not None:
            body["model_ids"] = (int(model_ids)
                                 if not hasattr(model_ids, "__len__")
                                 else [int(x) for x in model_ids])
        if mask_types is not None:
            body["mask_types"] = (int(mask_types)
                                  if not hasattr(mask_types, "__len__")
                                  else [int(x) for x in mask_types])
        out = self._call("POST", "/v1/ingest", body, idempotent=False)
        return {**out, **out["applied"]}

    def delete_masks(self, mask_ids) -> dict:
        out = self._call("POST", "/v1/delete",
                         {"mask_ids": [int(x) for x in mask_ids]},
                         idempotent=False)
        return {**out, **out["applied"]}

    def next_page(self, session_id: str, k: Optional[int] = None) -> dict:
        """Advance a session: ``session_id`` is the cursor returned in the
        previous payload's ``session`` field (bare legacy ids work too)."""
        body: dict = {"cursor": session_id}
        if k is not None:
            body["k"] = int(k)
        return self._page_compat(self._call("POST", "/v1/page", body),
                                 fallback_cursor=session_id)

    def drop_session(self, session_id: str) -> dict:
        return self._call("POST", "/v1/session/drop",
                          {"cursor": session_id}, idempotent=False)

    def stats(self) -> dict:
        return self._call("GET", "/v1/stats")

    def healthz(self) -> dict:
        return self._call("GET", "/v1/healthz")

    # -- observability ----------------------------------------------------
    def explain(self, sql: str, *, analyze: bool = True, rois=None) -> dict:
        """``EXPLAIN [ANALYZE] <sql>`` → the (annotated) operator tree.
        Idempotent if ``sql`` already carries an EXPLAIN prefix."""
        if not sql.lstrip().upper().startswith("EXPLAIN"):
            sql = ("EXPLAIN ANALYZE " if analyze else "EXPLAIN ") + sql
        return self.query(sql, rois=rois)

    def metrics(self) -> str:
        """The Prometheus text exposition from ``GET /v1/metrics``."""
        return self._call("GET", "/v1/metrics", raw=True)

    def trace(self, query_id: str = "last", *, fmt: str = "json") -> dict:
        """A retained span tree (``fmt="chrome"`` → trace-event JSON)."""
        suffix = f"?format={fmt}" if fmt != "json" else ""
        return self._call("GET", f"/v1/trace/{query_id}{suffix}")

    def stream_query(self, sql: str, *, rois=None,
                     page_size: Optional[int] = None, k: Optional[int] = None):
        """Open a streaming session against the async tier: yields one
        cursor-paged ``/v1`` payload per chunk until the ranking is
        exhausted.  (The threaded server does not stream; use the async
        tier — :mod:`repro_torch.service.asyncserver`.)"""
        body: dict = {"sql": sql, "session": True, "stream": True}
        if page_size is not None:
            body["page_size"] = page_size
        if k is not None:
            body["k"] = int(k)
        if rois is not None:
            body["rois"] = [[int(v) for v in row] for row in rois]
        req = _request.Request(
            self.base_url + "/v1/query", data=json.dumps(body).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        try:
            with _request.urlopen(req, timeout=self.timeout) as resp:
                for line in resp:
                    line = line.strip()
                    if line:
                        yield json.loads(line)
        except HTTPError as e:
            raise self._error_from(e) from e
