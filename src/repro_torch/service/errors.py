"""Service error taxonomy + the /v1 structured error envelope.

Every error a ``/v1`` route can return is one JSON shape::

    {"error": {"code": "<machine code>", "type": "<exception class>",
               "message": "<human text>", "retry_after": <seconds>?}}

``code`` is a small closed vocabulary (the API contract — see DESIGN.md
§14's error-code taxonomy); ``type`` is the Python exception class that
produced it (diagnostic, not contractual).  ``retry_after`` appears only
on shed responses (429) and mirrors the ``Retry-After`` HTTP header.

Legacy unversioned routes keep their historical ``{"error": "<str>"}``
bodies; only the mapping from exception to HTTP status is shared.
"""

from __future__ import annotations

from ..core.store import StaleRunError

__all__ = [
    "NotFoundError", "RateLimitedError", "OverloadedError",
    "BadCursorError", "error_status", "error_envelope",
]


class NotFoundError(KeyError):
    """An addressable resource (session, trace, route) does not exist.

    Subclasses ``KeyError`` so direct API callers that historically caught
    ``KeyError`` keep working — but the HTTP guards catch *this* class for
    404, so a genuine ``KeyError`` escaping from engine internals surfaces
    as the 500 it really is instead of masquerading as "not found".
    """

    def __str__(self) -> str:  # KeyError repr()s its message; undo that
        return self.args[0] if self.args else ""


class BadCursorError(ValueError):
    """An opaque continuation cursor failed to decode."""


class RateLimitedError(Exception):
    """A tenant exceeded its token-bucket quota; retry after a delay."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = float(retry_after)


class OverloadedError(Exception):
    """A bounded request queue (or the connection budget) is full — the
    tier sheds instead of queueing unboundedly; retry after a delay."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = float(retry_after)


# exception class -> (HTTP status, envelope code), most-specific first.
_TAXONOMY: tuple = (
    (RateLimitedError, (429, "rate_limited")),
    (OverloadedError, (429, "overloaded")),
    (NotFoundError, (404, "not_found")),
    (StaleRunError, (409, "stale_epoch")),
    (BadCursorError, (400, "bad_cursor")),
    (SyntaxError, (400, "bad_request")),
    (ValueError, (400, "bad_request")),
)


def error_status(exc: BaseException) -> tuple[int, str]:
    """→ (HTTP status, envelope code) for any exception (500/internal
    fallback).  A genuine ``KeyError`` is *not* in the taxonomy: it maps
    to 500 like any other engine fault."""
    for cls, mapping in _TAXONOMY:
        if isinstance(exc, cls):
            return mapping
    return 500, "internal"


def error_envelope(exc: BaseException) -> tuple[int, dict, float | None]:
    """→ (HTTP status, /v1 error body, retry_after seconds or None)."""
    status, code = error_status(exc)
    if status == 500:
        message = f"{type(exc).__name__}: {exc}"
    else:
        message = str(exc)
    err: dict = {"code": code, "type": type(exc).__name__,
                 "message": message}
    retry_after = getattr(exc, "retry_after", None)
    if retry_after is not None:
        err["retry_after"] = float(retry_after)
    return status, {"error": err}, retry_after
