"""Span tracing for the query engine (DESIGN.md §10).

Every traced query produces one **span tree** mirroring the
filter–verification pipeline: ``query`` → ``parse`` → ``plan.compile`` →
per-expression ``bounds`` spans (candidates, CHI bytes touched) →
``verify.round`` spans (masks, bytes, cache hits) — plus
``scheduler.fused_pass`` / ``scheduler.pair_pass`` when the service's
cross-query scheduler drives verification.  The span *structure* (names,
nesting, candidate/verified counts) is identical across the host, device,
and mesh backends because instrumentation lives in the backend-agnostic
drivers, never in the physical layers.

Design constraints:

* **Near-zero overhead when disabled.**  Instrumented code calls the
  module-level :func:`span`; with tracing off that is one contextvar read,
  one attribute check, and the shared no-op singleton — no Span object is
  ever allocated (``Tracer.spans_started`` stays 0, which the tests assert
  directly instead of timing).
* **Thread-safe, contextvar-scoped.**  The active tracer and the current
  parent span are both contextvars, so concurrent server threads build
  disjoint trees; the finished-trace ring buffer is lock-guarded.
* **Exportable.**  A finished trace renders as nested JSON
  (:meth:`Span.to_dict`) or as the Chrome trace-event format
  (:func:`chrome_trace` — load the JSON file in Perfetto / chrome://tracing).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import time
from collections import OrderedDict
from typing import Optional

from .. import lockcheck

__all__ = ["Span", "Tracer", "span", "current_tracer", "chrome_trace",
           "NOOP_SPAN", "GLOBAL_TRACER"]


def _jsonable(v):
    """Attrs may carry numpy scalars; normalize for json.dumps."""
    if isinstance(v, bool) or v is None or isinstance(v, (str, int, float)):
        return v
    if hasattr(v, "item"):
        return v.item()
    return repr(v)


class Span:
    """One timed node of a trace tree.  Use as a context manager; annotate
    with :meth:`set` (attrs merge; later wins)."""

    __slots__ = ("name", "t0", "dur_s", "attrs", "children",
                 "_tracer", "_token")

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self.t0 = 0.0
        self.dur_s = 0.0
        self.attrs: dict = {}
        self.children: list = []
        self._tracer = tracer
        self._token = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    # -- context management ----------------------------------------------
    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        self._token = _CURRENT_SPAN.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_s = time.perf_counter() - self.t0
        _CURRENT_SPAN.reset(self._token)
        self._token = None
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        if _CURRENT_SPAN.get() is None:
            # finished root: record into the owning tracer's ring buffer
            self._tracer._record(self)
        return False

    # -- export -----------------------------------------------------------
    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "dur_s": self.dur_s}
        if self.attrs:
            d["attrs"] = {k: _jsonable(v) for k, v in self.attrs.items()}
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def walk(self):
        """Depth-first iteration over the subtree (self first)."""
        yield self
        for c in self.children:
            yield from c.walk()

    def structure(self) -> tuple:
        """The backend-invariant shape of the subtree: span names, nesting,
        and the count-valued attrs (times/bytes excluded — those may differ
        across physical backends; counts must not)."""
        counts = {k: _jsonable(v) for k, v in self.attrs.items()
                  if k in _STRUCTURAL_ATTRS}
        return (self.name, tuple(sorted(counts.items())),
                tuple(c.structure() for c in self.children))


#: Attr names that must be bit-identical across execution backends.
_STRUCTURAL_ATTRS = frozenset({
    "candidates", "decided_by_bounds", "verified", "batch", "rounds",
    "kind", "expr", "cached", "n_results",
})


class _NoopSpan:
    """Shared disabled-path singleton: every operation is a no-op and
    returns ``self``, so instrumented code never branches."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()

_CURRENT_SPAN: contextvars.ContextVar[Optional[Span]] = \
    contextvars.ContextVar("repro_obs_current_span", default=None)
_ACTIVE_TRACER: contextvars.ContextVar[Optional["Tracer"]] = \
    contextvars.ContextVar("repro_obs_active_tracer", default=None)


class Tracer:
    """Builds span trees and retains the most recent finished traces.

    One tracer per scope that wants retrievable traces (the service owns
    one; tests build their own).  ``enabled=False`` (the default for the
    global ambient tracer) short-circuits :func:`span` to the no-op
    singleton."""

    def __init__(self, enabled: bool = False, max_traces: int = 64):
        self.enabled = enabled
        self.max_traces = max_traces
        self.spans_started = 0           # the zero-allocation check counter
        self._traces: OrderedDict[str, Span] = OrderedDict()
        self._ids = itertools.count(1)
        self._lock = lockcheck.make_lock("obs.tracer")

    # -- span creation -----------------------------------------------------
    def span(self, name: str):
        """Start a child span of the current context (or a new root)."""
        if not self.enabled:
            return NOOP_SPAN
        with self._lock:
            self.spans_started += 1
        sp = Span(name, self)
        parent = _CURRENT_SPAN.get()
        if parent is not None:
            parent.children.append(sp)
        return sp

    def query_span(self, label: str = "", query_id: Optional[str] = None):
        """Start a root ``query`` span with an assigned ``query_id`` attr
        (available immediately, so callers can return it before the trace
        finishes).  Inside an existing trace it nests as an ordinary
        child span."""
        sp = self.span("query")
        if sp is NOOP_SPAN:
            return sp
        with self._lock:
            qid = query_id or f"q{next(self._ids)}"
        sp.set(query_id=qid)
        if label:
            sp.set(label=str(label)[:400])
        return sp

    @contextlib.contextmanager
    def activate(self):
        """Make this tracer the ambient one for the calling context (what
        the module-level :func:`span` resolves to)."""
        token = _ACTIVE_TRACER.set(self)
        try:
            yield self
        finally:
            _ACTIVE_TRACER.reset(token)

    # -- finished-trace retention -----------------------------------------
    def _record(self, root: Span) -> None:
        qid = root.attrs.get("query_id")
        if qid is None:
            with self._lock:
                qid = f"q{next(self._ids)}"
            root.attrs["query_id"] = qid
        with self._lock:
            self._traces[str(qid)] = root
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    def get_trace(self, query_id: str) -> Optional[Span]:
        with self._lock:
            return self._traces.get(str(query_id))

    def trace_ids(self) -> list:
        with self._lock:
            return list(self._traces)

    def last_trace(self) -> Optional[Span]:
        with self._lock:
            if not self._traces:
                return None
            return next(reversed(self._traces.values()))

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


GLOBAL_TRACER = Tracer(enabled=False)


def current_tracer() -> Tracer:
    """The ambient tracer: the innermost :meth:`Tracer.activate` scope, or
    the process-global (disabled-by-default) tracer."""
    return _ACTIVE_TRACER.get() or GLOBAL_TRACER


def span(name: str):
    """Start a span on the ambient tracer — the one call instrumented code
    makes.  Disabled path: contextvar read + attr check + shared no-op."""
    t = _ACTIVE_TRACER.get() or GLOBAL_TRACER
    if not t.enabled:
        return NOOP_SPAN
    return t.span(name)


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------


def chrome_trace(root: Span, *, pid: int = 1, tid: int = 1) -> dict:
    """Render a finished trace as the Chrome trace-event JSON object format:
    complete ("ph": "X") events with microsecond timestamps relative to the
    root.  ``json.dump`` the result to a file and open it in Perfetto
    (ui.perfetto.dev) or chrome://tracing."""
    events = []
    base = root.t0
    for sp in root.walk():
        events.append({
            "name": sp.name,
            "ph": "X",
            "ts": (sp.t0 - base) * 1e6,
            "dur": sp.dur_s * 1e6,
            "pid": pid,
            "tid": tid,
            "args": {k: _jsonable(v) for k, v in sp.attrs.items()},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
