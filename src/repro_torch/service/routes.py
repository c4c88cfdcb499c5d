"""Transport-agnostic ``/v1`` API core: request parsing, opaque
continuation cursors, and response shaping.

Both HTTP fronts — the legacy threaded server (:mod:`.server`) and the
async tier (:mod:`.asyncserver`) — route through this module, so the
``/v1`` contract cannot drift between them:

* **Uniform envelopes** — errors are structured
  ``{"error": {"code", "type", "message", "retry_after"?}}``
  (:mod:`.errors`); mutations return ``{"epoch", "applied", ...}``;
  session paging speaks opaque continuation cursors
  (``{"cursor": ...}`` in, ``{"cursor"|null, "items", "exhausted"}``
  out) instead of bare session ids.
* **Legacy shims** — the unversioned routes keep serving byte-identical
  payloads: they call the same service methods and return the raw
  (historical) payload untouched; ``/v1`` responses are a *reshaping* of
  that same payload, so the two can never disagree on content.

Cursor format (DESIGN.md §14): ``c1.<base64url(json {"s": sid, "o":
served})>`` — versioned, unpadded, order-stable.  The ``o`` component is
advisory (the session tracks its own frontier); decoding never trusts it
for anything but surfacing ``offset`` to the caller.  A bare legacy
session id is accepted where a cursor is expected, so mixed-era clients
interoperate.
"""

from __future__ import annotations

import base64
import binascii
import json
from typing import Optional

import numpy as np

from .errors import BadCursorError

_CURSOR_PREFIX = "c1."


# -- opaque continuation cursors ------------------------------------------

def encode_cursor(session_id: str, served: int) -> str:
    raw = json.dumps({"s": session_id, "o": int(served)},
                     separators=(",", ":")).encode()
    return _CURSOR_PREFIX + \
        base64.urlsafe_b64encode(raw).rstrip(b"=").decode()


def decode_cursor(cursor: str) -> str:
    """→ session id.  Accepts a bare legacy session id for interop."""
    if not isinstance(cursor, str) or not cursor:
        raise BadCursorError(f"cursor must be a non-empty string, "
                             f"got {cursor!r}")
    if not cursor.startswith(_CURSOR_PREFIX):
        return cursor                       # bare legacy session id
    payload = cursor[len(_CURSOR_PREFIX):]
    try:
        pad = "=" * (-len(payload) % 4)
        obj = json.loads(base64.urlsafe_b64decode(payload + pad))
        return obj["s"]
    except (ValueError, KeyError, TypeError, binascii.Error) as e:
        raise BadCursorError(f"undecodable cursor {cursor!r}") from e


# -- request parsing (shared by both fronts) ------------------------------

def parse_rois(body: dict) -> Optional[np.ndarray]:
    rois = body.get("rois")
    return np.asarray(rois, np.int64) if rois else None


def query_kwargs(body: dict) -> dict:
    """Body of POST /query | /v1/query → ``service.query`` kwargs."""
    if "sql" not in body:
        raise ValueError("body must contain 'sql'")
    return {"sql": body["sql"], "rois": parse_rois(body),
            "session": bool(body.get("session", False)),
            "page_size": body.get("page_size")}


def workload_sqls(body: dict) -> list:
    if "sqls" not in body:
        raise ValueError("body must contain 'sqls'")
    return list(body["sqls"])


def ingest_kwargs(body: dict) -> dict:
    if "masks" not in body:
        raise ValueError("body must contain 'masks'")
    return {"masks": np.asarray(body["masks"], np.float32),
            "mask_ids": body.get("mask_ids"),
            "image_ids": body.get("image_ids"),
            "model_ids": body.get("model_ids"),
            "mask_types": body.get("mask_types"),
            "on_conflict": body.get("on_conflict", "error")}


def delete_ids(body: dict) -> list:
    if "mask_ids" not in body:
        raise ValueError("body must contain 'mask_ids'")
    return body["mask_ids"]


def page_request(body: dict) -> tuple[str, Optional[int]]:
    """Body of POST /v1/page → (session id, k)."""
    if "cursor" not in body:
        raise ValueError("body must contain 'cursor'")
    k = body.get("k")
    if k is not None:
        try:
            k = int(k)
        except (TypeError, ValueError):
            raise ValueError(f"bad page size k={k!r}")
    return decode_cursor(body["cursor"]), k


# -- /v1 response shaping --------------------------------------------------
# Each shaper takes the *legacy* service payload (the raw dict the
# MaskSearchService method returned) and reshapes it; the legacy routes
# serve that input untouched, which is what keeps the shims byte-identical.

def shape_page(payload: dict) -> dict:
    """Legacy session/page payload → the /v1 cursor contract."""
    page = payload["page"]
    items = [{"id": i, "score": s}
             for i, s in zip(page["ids"], page["scores"])]
    exhausted = bool(payload["exhausted"])
    out = {
        "kind": payload["kind"],
        "items": items,
        "cursor": (None if exhausted
                   else encode_cursor(payload["session"], payload["served"])),
        "exhausted": exhausted,
        "offset": page["offset"],
        "served": payload["served"],
        "total_candidates": payload["total_candidates"],
        "stats": payload["stats"],
        "cache_hit": payload["cache_hit"],
    }
    if "query_id" in payload:
        out["query_id"] = payload["query_id"]
    return out


def shape_query(payload: dict) -> dict:
    """Legacy one-shot / session-open query payload → /v1 shape.

    One-shots already fit the contract (kind + ids/scores/value + stats);
    session opens become the cursor-paged shape."""
    if "page" in payload and "session" in payload:
        return shape_page(payload)
    if payload.get("explain"):
        return payload                       # EXPLAIN report: verbatim
    return payload


def shape_workload(payloads: list) -> dict:
    return {"items": [shape_query(p) for p in payloads]}


def shape_ingest(payload: dict) -> dict:
    return {"epoch": payload["epoch"],
            "applied": {"appended": payload["appended"],
                        "updated": payload["updated"]},
            "n_masks": payload["n_masks"],
            "mask_ids": payload["mask_ids"],
            "evicted_cache_entries": payload["evicted_cache_entries"]}


def shape_delete(payload: dict) -> dict:
    return {"epoch": payload["epoch"],
            "applied": {"deleted": payload["deleted"]},
            "n_masks": payload["n_masks"],
            "evicted_cache_entries": payload["evicted_cache_entries"]}
