"""Async serving tier: thousands of concurrent connections over one
:class:`MaskSearchService` (DESIGN.md §14).

The legacy :mod:`.server` front is a ``ThreadingHTTPServer`` — a thread
per request, HTTP/1.0 close-per-connection, a listen backlog of five.
Past a few hundred concurrent clients it drowns in thread churn and
refused connects while the service lock (the real bottleneck) sits
mostly idle between requests.  This tier inverts the design:

* **asyncio event loop** — one thread multiplexes every connection with
  keep-alive HTTP/1.1; accepting a client costs a coroutine, not a
  thread.  Connections beyond ``max_connections`` are shed immediately
  with 429 + ``Retry-After`` instead of queueing in the kernel backlog.
* **Admission control** (:mod:`.admission`) — per-tenant token buckets
  and bounded FIFOs drained deficit-round-robin, so overload degrades
  into fast, honest 429s and no tenant starves another.
* **Batch dispatcher** — admitted work is drained in weighted-fair
  batches into :meth:`MaskSearchService.execute_many` on a bounded
  executor pool: one service-lock acquisition and **one** fused
  scheduler drive per batch.  Queries that arrive together — from
  *different tenants* — merge their verification residues into the same
  fused kernel passes (``SchedulerStats.cross_tenant_*``), which is
  where the throughput win comes from: the paper's multi-query
  optimization applied across users.
* **Streaming sessions** — ``POST /v1/query`` with ``"stream": true``
  returns a chunked NDJSON response, one cursor-paged ``/v1`` payload
  per chunk until the ranking is exhausted; continuation pages re-enter
  the dispatcher depth-exempt (already-admitted work is never shed
  mid-stream) and still fuse with whatever else is in flight.

Both the ``/v1`` namespace and the legacy unversioned routes are served,
through the same :mod:`.routes` core as the threaded server.

Run it::

    PYTHONPATH=src python -m repro_torch.service.asyncserver --synthetic 500 \\
        --port 8766 --tenant-rate 200 --queue-depth 128
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _http_reasons
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import routes
from .admission import AdmissionController
from .api import MaskSearchService
from .errors import NotFoundError, OverloadedError, error_envelope
from .server import _SESSION_PAGE_RE, _SESSION_RE, _TRACE_RE

_MAX_BODY = 64 * 1024 * 1024


@dataclasses.dataclass
class TierStats:
    """Monotonic tier counters (+ one gauge), surfaced at ``/metrics`` as
    ``repro_async_tier_*``.  Torn cross-thread reads from the scraper
    are tolerated, same stance as the service's query counts."""
    connections_total: int = 0
    connections_open: int = 0            # gauge
    shed_connections: int = 0            # over max_connections
    requests_total: int = 0
    completed: int = 0
    http_errors: int = 0                 # responses with status >= 400
    batches: int = 0                     # execute_many dispatches
    batched_requests: int = 0            # pendings folded into them
    stream_pages: int = 0                # chunks pushed on NDJSON streams

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Pending:
    """One admitted request: its execute_many items and the future the
    connection coroutine awaits."""

    __slots__ = ("items", "future")

    def __init__(self, items: list, future: asyncio.Future):
        self.items = items
        self.future = future


class AsyncTier:
    def __init__(self, service: MaskSearchService, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_connections: int = 4096,
                 executor_workers: int = 4,
                 tenant_rate: float = 500.0, tenant_burst: float = 250.0,
                 queue_depth: int = 256,
                 tenant_weights: Optional[dict] = None,
                 batch_max: int = 32, max_inflight_batches: int = 2,
                 stream_page_limit: int = 10_000):
        self.service = service
        self.host = host
        self.port = port
        self.max_connections = max_connections
        self.batch_max = max(int(batch_max), 1)
        self.max_inflight_batches = max(int(max_inflight_batches), 1)
        self.stream_page_limit = stream_page_limit
        self.stats = TierStats()
        self.admission = AdmissionController(
            rate=tenant_rate, burst=tenant_burst, depth=queue_depth,
            weights=tenant_weights)
        # bounded pool: execute_many serializes on the service lock anyway,
        # so a couple of workers keep it saturated while one drains results
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(executor_workers), 1),
            thread_name_prefix="repro-async-tier")
        self._server: Optional[asyncio.AbstractServer] = None
        self._dispatcher: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._inflight: Optional[asyncio.Semaphore] = None
        self._closing = False
        service.metrics.register_collector(_tier_sampler(self))

    # -- lifecycle --------------------------------------------------------
    async def start(self) -> None:
        self._wake = asyncio.Event()
        self._inflight = asyncio.Semaphore(self.max_inflight_batches)
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port,
            backlog=min(self.max_connections, 4096))
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatcher = asyncio.ensure_future(self._dispatch_loop())

    async def close(self) -> None:
        self._closing = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except asyncio.CancelledError:
                pass
        self._pool.shutdown(wait=False)

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- HTTP plumbing ----------------------------------------------------
    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        """→ (method, target, headers, body) or None on EOF/garbage."""
        try:
            line = await reader.readline()
            if not line:
                return None
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return None
            method, target = parts[0], parts[1]
            headers: dict = {}
            while True:
                h = await reader.readline()
                if not h:
                    return None
                if h in (b"\r\n", b"\n"):
                    break
                name, _, value = h.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
            n = int(headers.get("content-length") or 0)
            if not 0 <= n <= _MAX_BODY:
                return None
            body = await reader.readexactly(n) if n else b""
            return method, target, headers, body
        except (ConnectionError, asyncio.IncompleteReadError, ValueError,
                UnicodeDecodeError):
            return None

    @staticmethod
    def _response_bytes(code: int, body: bytes, *,
                        content_type: str = "application/json",
                        retry_after: Optional[float] = None,
                        close: bool = False) -> bytes:
        reason = _http_reasons.get(code, "Unknown")
        head = [f"HTTP/1.1 {code} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}"]
        if retry_after is not None:
            head.append(f"Retry-After: {max(1, int(-(-retry_after // 1)))}")
        head.append(f"Connection: {'close' if close else 'keep-alive'}")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body

    def _json_response(self, code: int, obj, *,
                       retry_after: Optional[float] = None,
                       close: bool = False) -> bytes:
        if code >= 400:
            self.stats.http_errors += 1
        return self._response_bytes(
            code, json.dumps(obj).encode(), retry_after=retry_after,
            close=close)

    def _error_response(self, exc: Exception, *, v1: bool) -> bytes:
        status, envelope, retry_after = error_envelope(exc)
        obj = envelope if v1 else {"error": envelope["error"]["message"]}
        return self._json_response(status, obj, retry_after=retry_after)

    # -- connection loop --------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self.stats.connections_total += 1
        if self.stats.connections_open >= self.max_connections:
            self.stats.shed_connections += 1
            try:
                writer.write(self._error_response(
                    OverloadedError(
                        f"connection limit {self.max_connections} reached",
                        0.5),
                    v1=True))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
            finally:
                writer.close()
            return
        self.stats.connections_open += 1
        try:
            while not self._closing:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, target, headers, body = req
                self.stats.requests_total += 1
                keep = headers.get("connection", "").lower() != "close"
                try:
                    streamed = await self._route(method, target, headers,
                                                 body, writer, keep=keep)
                except (ConnectionError, OSError):
                    break
                self.stats.completed += 1
                if streamed or not keep:
                    break
        finally:
            self.stats.connections_open -= 1
            try:
                writer.close()
            except Exception:       # noqa: BLE001 — teardown best-effort
                pass

    # -- routing ----------------------------------------------------------
    async def _route(self, method: str, target: str, headers: dict,
                     body: bytes, writer: asyncio.StreamWriter, *,
                     keep: bool) -> bool:
        """Serve one request; → True when the response was streamed (the
        connection closes afterwards)."""
        parsed = urlparse(target)
        path = parsed.path
        v1 = path.startswith("/v1/")
        tenant = headers.get("x-tenant", "default")
        loop = asyncio.get_running_loop()

        async def send(payload: bytes) -> None:
            writer.write(payload)
            await writer.drain()

        try:
            if method == "GET":
                if path in ("/healthz", "/v1/healthz"):
                    await send(self._json_response(200, {"ok": True},
                                                   close=not keep))
                    return False
                if path in ("/stats", "/v1/stats"):
                    out = await loop.run_in_executor(self._pool,
                                                     self.service.stats)
                    await send(self._json_response(200, out, close=not keep))
                    return False
                if path in ("/metrics", "/v1/metrics"):
                    text = await loop.run_in_executor(
                        self._pool, self.service.metrics_text)
                    await send(self._response_bytes(
                        200, text.encode(),
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8", close=not keep))
                    return False
                m = _TRACE_RE.match(path)
                if m:
                    qid = m.group(1)
                    fmt = (parse_qs(parsed.query).get("format")
                           or ["json"])[0]
                    if fmt not in ("json", "chrome"):
                        raise ValueError(f"format must be json|chrome, "
                                         f"got {fmt!r}")
                    out = await loop.run_in_executor(
                        self._pool,
                        lambda: self.service.trace(qid, fmt=fmt))
                    await send(self._json_response(200, out, close=not keep))
                    return False
                m = _SESSION_PAGE_RE.match(path)
                if m:                       # legacy GET session page
                    sid = m.group(1)
                    qs = parse_qs(parsed.query)
                    try:
                        k = int(qs["k"][0]) if "k" in qs else None
                    except ValueError:
                        raise ValueError(f"bad page size k={qs['k'][0]!r}")
                    payload = await self._execute_one(
                        tenant, {"op": "page", "session_id": sid, "k": k})
                    await send(self._json_response(200, payload,
                                                   close=not keep))
                    return False
                raise NotFoundError(f"no route {path}")

            if method == "DELETE":
                m = _SESSION_RE.match(path)
                if m:
                    sid = m.group(1)
                    out = await loop.run_in_executor(
                        self._pool,
                        lambda: {"dropped": self.service.drop_session(sid)})
                    await send(self._json_response(200, out, close=not keep))
                    return False
                raise NotFoundError(f"no route {path}")

            if method != "POST":
                raise NotFoundError(f"no route {method} {path}")

            req_body = json.loads(body or b"{}")

            if path in ("/query", "/v1/query"):
                kw = routes.query_kwargs(req_body)
                if v1 and req_body.get("stream"):
                    await self._stream_query(tenant, req_body, writer)
                    return True
                item = {"op": "query", "sql": kw["sql"], "rois": kw["rois"],
                        "session": kw["session"],
                        "page_size": kw["page_size"]}
                payload = await self._execute_one(tenant, item)
                out = routes.shape_query(payload) if v1 else payload
                await send(self._json_response(200, out, close=not keep))
                return False

            if path in ("/workload", "/v1/workload"):
                sqls = routes.workload_sqls(req_body)
                rois = routes.parse_rois(req_body)
                items = [{"op": "query", "sql": sql, "rois": rois}
                         for sql in sqls]
                results = await self._submit(tenant, items)
                for status, value in results:
                    if status == "error":   # legacy submit_batch semantics:
                        raise value         # one bad query fails the batch
                payloads = [value for _, value in results]
                out = (routes.shape_workload(payloads) if v1 else payloads)
                await send(self._json_response(200, out, close=not keep))
                return False

            if path == "/v1/page":
                sid, k = routes.page_request(req_body)
                payload = await self._execute_one(
                    tenant, {"op": "page", "session_id": sid, "k": k})
                await send(self._json_response(200, routes.shape_page(payload),
                                               close=not keep))
                return False

            if path in ("/ingest", "/v1/ingest"):
                kw = routes.ingest_kwargs(req_body)
                self.admission.charge(tenant)
                out = await loop.run_in_executor(
                    self._pool, lambda: self.service.ingest(**kw))
                await send(self._json_response(
                    200, routes.shape_ingest(out) if v1 else out,
                    close=not keep))
                return False

            if path in ("/delete", "/v1/delete"):
                ids = routes.delete_ids(req_body)
                self.admission.charge(tenant)
                out = await loop.run_in_executor(
                    self._pool, lambda: self.service.delete(ids))
                await send(self._json_response(
                    200, routes.shape_delete(out) if v1 else out,
                    close=not keep))
                return False

            if path == "/v1/session/drop":
                if "cursor" not in req_body:
                    raise ValueError("body must contain 'cursor'")
                sid = routes.decode_cursor(req_body["cursor"])
                out = await loop.run_in_executor(
                    self._pool,
                    lambda: {"dropped": self.service.drop_session(sid)})
                await send(self._json_response(200, out, close=not keep))
                return False

            raise NotFoundError(f"no route {path}")
        except (ConnectionError, OSError):
            raise
        except Exception as e:          # noqa: BLE001 — serving loop
            await send(self._error_response(e, v1=v1))
            return False

    # -- admitted execution ----------------------------------------------
    async def _submit(self, tenant: str, items: list, *,
                      force: bool = False) -> list:
        """Admit a request's items and await the dispatcher's results
        (aligned ``("ok", payload) | ("error", exc)`` tuples)."""
        for item in items:
            item["tenant"] = tenant
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self.admission.admit(tenant, _Pending(items, future), force=force)
        self._wake.set()
        return await future

    async def _execute_one(self, tenant: str, item: dict, *,
                           force: bool = False) -> dict:
        status, value = (await self._submit(tenant, [item],
                                            force=force))[0]
        if status == "error":
            raise value
        return value

    async def _dispatch_loop(self) -> None:
        """Drain the admission queue in weighted-fair batches; each batch
        is one ``execute_many`` call — one lock acquisition, one fused
        drive — on the executor pool."""
        while True:
            await self._wake.wait()
            self._wake.clear()
            while len(self.admission.queue):
                await self._inflight.acquire()
                batch = self.admission.queue.pop_batch(self.batch_max)
                if not batch:
                    self._inflight.release()
                    break
                pendings = [p for _, p in batch]
                asyncio.ensure_future(self._run_batch(pendings))

    async def _run_batch(self, pendings: list) -> None:
        items: list = []
        for p in pendings:
            items.extend(p.items)
        try:
            results = await asyncio.get_running_loop().run_in_executor(
                self._pool, self.service.execute_many, items)
        except Exception as e:          # noqa: BLE001 — batch-level fault
            for p in pendings:
                if not p.future.done():
                    p.future.set_exception(e)
        else:
            i = 0
            for p in pendings:
                n = len(p.items)
                if not p.future.done():
                    p.future.set_result(results[i:i + n])
                i += n
            self.stats.batches += 1
            self.stats.batched_requests += len(pendings)
        finally:
            self._inflight.release()
            self._wake.set()

    # -- streaming --------------------------------------------------------
    async def _stream_query(self, tenant: str, req_body: dict,
                            writer: asyncio.StreamWriter) -> None:
        """Chunked NDJSON: the opening page, then every continuation page
        until the ranking is exhausted.  The open is admitted normally;
        continuation pages are depth-exempt (``force=True``) — the tier
        never sheds a stream it already accepted."""
        kw = routes.query_kwargs(req_body)
        item = {"op": "query", "sql": kw["sql"], "rois": kw["rois"],
                "session": True, "page_size": kw["page_size"]}
        payload = await self._execute_one(tenant, item)
        if "session" not in payload:
            raise ValueError("stream requires a ranking (ORDER BY … LIMIT) "
                             "query")
        sid = payload["session"]
        k = req_body.get("k")

        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: application/x-ndjson\r\n"
                     b"Transfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")

        async def chunk(obj) -> None:
            data = json.dumps(obj).encode() + b"\n"
            writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            await writer.drain()
            self.stats.stream_pages += 1

        try:
            shaped = routes.shape_page(payload)
            await chunk(shaped)
            pages = 1
            while not shaped["exhausted"] and pages < self.stream_page_limit:
                payload = await self._execute_one(
                    tenant, {"op": "page", "session_id": sid, "k": k},
                    force=True)
                shaped = routes.shape_page(payload)
                await chunk(shaped)
                pages += 1
        finally:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    self._pool, lambda: self.service.drop_session(sid))
            except Exception:       # noqa: BLE001 — teardown best-effort
                pass
        writer.write(b"0\r\n\r\n")
        await writer.drain()


def _tier_sampler(tier: AsyncTier):
    """Scrape-time collector reflecting tier + admission counters into the
    service registry (``repro_async_tier_*`` / ``repro_admission_*``)."""
    def collect() -> list:
        out = []
        for prefix, stats in (("repro_async_tier", tier.stats),
                              ("repro_admission", tier.admission.stats)):
            for f in dataclasses.fields(stats):
                v = getattr(stats, f.name)
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out.append((f"{prefix}_{f.name}", "gauge",
                            "async tier counter", [({}, float(v))]))
        out.append(("repro_admission_queued", "gauge",
                    "work waiting in the fair queue",
                    [({}, float(len(tier.admission.queue)))]))
        return out
    return collect


# -- embedding helpers (tests / benchmarks) --------------------------------

class TierHandle:
    """A tier running on a daemon event-loop thread."""

    def __init__(self, tier: AsyncTier, loop: asyncio.AbstractEventLoop,
                 thread: threading.Thread):
        self.tier = tier
        self.loop = loop
        self.thread = thread
        self.base_url = tier.base_url

    def stop(self, timeout: float = 10.0) -> None:
        asyncio.run_coroutine_threadsafe(
            self.tier.close(), self.loop).result(timeout=timeout)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=timeout)


def serve_in_thread(service: MaskSearchService, **tier_kwargs) -> TierHandle:
    """Start an :class:`AsyncTier` on a background event loop; → handle
    with ``base_url`` and ``stop()``."""
    loop = asyncio.new_event_loop()
    tier = AsyncTier(service, **tier_kwargs)
    started = threading.Event()
    boot_error: list = []

    def run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(tier.start())
        except Exception as e:      # noqa: BLE001 — surfaced to caller
            boot_error.append(e)
            started.set()
            return
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True,
                              name="repro-async-tier-loop")
    thread.start()
    started.wait()
    if boot_error:
        raise boot_error[0]
    return TierHandle(tier, loop, thread)


# -- CLI -------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="MaskSearch async serving tier")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--root", help="existing on-disk mask DB root")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="serve an N-mask synthetic in-memory DB")
    ap.add_argument("--size", type=int, default=128,
                    help="mask side for --synthetic")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8766)
    ap.add_argument("--verify-batch", type=int, default=256)
    ap.add_argument("--backend", default=None,
                    choices=("host", "device", "mesh"),
                    help="default: device on a cuda store, host on a cpu one")
    ap.add_argument("--device", default="cuda",
                    help="torch device the store lives on (cuda, or cpu)")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--max-connections", type=int, default=4096)
    ap.add_argument("--executor-workers", type=int, default=4)
    ap.add_argument("--tenant-rate", type=float, default=500.0,
                    help="per-tenant admission rate (tokens/s)")
    ap.add_argument("--tenant-burst", type=float, default=250.0)
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="per-tenant bounded queue depth")
    ap.add_argument("--batch-max", type=int, default=32,
                    help="max admitted requests per execute_many batch")
    ap.add_argument("--max-inflight-batches", type=int, default=2)
    args = ap.parse_args(argv)

    from .server import _synthetic_store
    if args.root:
        from ..core import MaskStore
        store, rois = MaskStore.open_disk(args.root, device=args.device), None
    else:
        store, rois = _synthetic_store(args.synthetic, args.size,
                                       device=args.device)
    service = MaskSearchService(store, provided_rois=rois,
                                verify_batch=args.verify_batch,
                                backend=args.backend, trace=args.trace)
    tier = AsyncTier(service, host=args.host, port=args.port,
                     max_connections=args.max_connections,
                     executor_workers=args.executor_workers,
                     tenant_rate=args.tenant_rate,
                     tenant_burst=args.tenant_burst,
                     queue_depth=args.queue_depth,
                     batch_max=args.batch_max,
                     max_inflight_batches=args.max_inflight_batches)

    async def serve() -> None:
        await tier.start()
        print(f"masksearch async tier: {len(store)} masks on "
              f"{tier.base_url}", flush=True)
        await asyncio.Event().wait()        # forever

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


if __name__ == "__main__":
    main()
