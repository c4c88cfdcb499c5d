"""Instrumented-lock mode: runtime teeth for the lock-discipline contract.

The static side of the contract lives in ``repro.analysis`` (masklint's
``lock-discipline`` / ``lock-order`` rules); this module is the dynamic
side.  With ``REPRO_LOCK_CHECK=1`` in the environment, every lock built
through :func:`make_lock` / :func:`make_rlock` is replaced by an
instrumented wrapper that turns silent races into loud failures:

* **owner tracking** — releasing a lock from a thread that does not hold
  it raises :class:`LockCheckError` (plain ``threading.Lock`` permits it);
* **ordering** — every *nested* acquisition records a directed edge
  ``outer → inner`` in a process-global lock-order graph, and an
  acquisition that would close a cycle (a latent deadlock: two threads
  taking the same pair of locks in opposite orders) raises immediately,
  even when the interleaving that would actually deadlock never happens
  in the test run;
* **hold-time accounting** — the longest time each named lock was held is
  recorded (:func:`hold_stats`); setting ``REPRO_LOCK_MAX_HOLD_S`` turns
  a budget overrun into an error.

With the variable unset (the default, and the production path) the
factories return plain ``threading.Lock()`` / ``threading.RLock()`` —
zero overhead, zero behaviour change.

:func:`guard_dict` extends the teeth to shared *containers*: it wraps a
dict so every mutation asserts that a given instrumented lock is held by
the calling thread.  Reads stay unguarded on purpose — the service's
``/metrics`` scrape reads counters without the service lock by design
(torn reads of monotonic counters are tolerated; torn *writes* are not).
"""

from __future__ import annotations

import os
import threading
import time

__all__ = [
    "LockCheckError", "enabled", "make_lock", "make_rlock", "guard_dict",
    "order_edges", "hold_stats", "reset_diagnostics",
]


class LockCheckError(AssertionError):
    """A violation of the lock discipline detected at runtime."""


def enabled() -> bool:
    """Whether instrumented-lock mode is on (``REPRO_LOCK_CHECK`` set to
    anything but empty/``0``).  Read at lock-construction time."""
    return os.environ.get("REPRO_LOCK_CHECK", "") not in ("", "0")


# -- process-global diagnostics ------------------------------------------------

_DIAG_LOCK = threading.Lock()
_ORDER_EDGES: dict[str, dict[str, str]] = {}   # outer -> {inner: site label}
_MAX_HOLD_S: dict[str, float] = {}             # name -> longest hold seconds
_HELD = threading.local()                      # per-thread stack of lock names


def _held_stack() -> list[str]:
    stack = getattr(_HELD, "stack", None)
    if stack is None:
        stack = _HELD.stack = []
    return stack


def _find_path(src: str, dst: str) -> list[str] | None:
    """A path src → … → dst in the order graph (DFS), or None."""
    seen = {src}
    trail = [(src, [src])]
    while trail:
        node, path = trail.pop()
        if node == dst:
            return path
        for nxt in _ORDER_EDGES.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                trail.append((nxt, path + [nxt]))
    return None


def _record_edge(outer: str, inner: str) -> None:
    """Record outer→inner; raise if the reverse direction is reachable
    (the pair of locks has now been taken in both orders somewhere)."""
    with _DIAG_LOCK:
        edges = _ORDER_EDGES.setdefault(outer, {})
        if inner in edges:
            return
        back = _find_path(inner, outer)
        if back is not None:
            raise LockCheckError(
                f"lock-order cycle: acquiring {inner!r} while holding "
                f"{outer!r}, but the graph already has "
                f"{' -> '.join(back)} — two threads taking these locks "
                f"in opposite orders can deadlock")
        edges[inner] = f"held {outer!r}"


def _record_hold(name: str, held_s: float) -> None:
    with _DIAG_LOCK:
        if held_s > _MAX_HOLD_S.get(name, 0.0):
            _MAX_HOLD_S[name] = held_s


def order_edges() -> dict[str, list[str]]:
    """The observed lock-order graph (outer name → inner names)."""
    with _DIAG_LOCK:
        return {k: sorted(v) for k, v in _ORDER_EDGES.items()}


def hold_stats() -> dict[str, float]:
    """Longest observed hold time per lock name, in seconds."""
    with _DIAG_LOCK:
        return dict(_MAX_HOLD_S)


def reset_diagnostics() -> None:
    """Clear the global order graph and hold stats (test isolation)."""
    with _DIAG_LOCK:
        _ORDER_EDGES.clear()
        _MAX_HOLD_S.clear()


# -- the instrumented wrappers -------------------------------------------------

class _InstrumentedBase:
    """Common owner/ordering/hold-time machinery over an inner lock.

    The inner primitive does the real blocking; all bookkeeping happens
    on the owning thread around it, so attributes like ``_owner`` are
    only written by whichever thread holds the inner lock (plus the
    pre-acquire checks, which read racily but fail toward detection)."""

    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = (threading.RLock() if self._reentrant
                       else threading.Lock())
        self._owner: int | None = None
        self._depth = 0
        self._acquired_at = 0.0
        budget = os.environ.get("REPRO_LOCK_MAX_HOLD_S", "")
        self._hold_budget_s = float(budget) if budget else 0.0

    # -- core protocol ---------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        reacquire = self._owner == me
        if reacquire and not self._reentrant:
            raise LockCheckError(
                f"lock {self.name!r}: non-reentrant re-acquire by the "
                f"owning thread (self-deadlock)")
        stack = _held_stack()
        if stack and not reacquire and self.name not in stack:
            _record_edge(stack[-1], self.name)
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        if self._depth == 0:
            self._owner = me
            self._acquired_at = time.perf_counter()
        self._depth += 1
        stack.append(self.name)
        return True

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me:
            raise LockCheckError(
                f"lock {self.name!r}: released by thread {me} but "
                f"held by {self._owner!r}")
        self._depth -= 1
        if self._depth == 0:
            held_s = time.perf_counter() - self._acquired_at
            _record_hold(self.name, held_s)
            self._owner = None
            if self._hold_budget_s and held_s > self._hold_budget_s:
                self._inner.release()
                self._pop_held()
                raise LockCheckError(
                    f"lock {self.name!r}: held {held_s:.3f}s, over the "
                    f"REPRO_LOCK_MAX_HOLD_S={self._hold_budget_s} budget")
        self._pop_held()
        self._inner.release()

    def _pop_held(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                return

    # -- conveniences ----------------------------------------------------
    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._owner is not None

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def assert_held(self) -> None:
        """Raise unless the calling thread currently owns this lock."""
        if self._owner != threading.get_ident():
            raise LockCheckError(
                f"lock {self.name!r}: required to be held by the calling "
                f"thread but owner is {self._owner!r}")

    def __repr__(self) -> str:
        state = f"held depth={self._depth}" if self._owner else "unlocked"
        return f"<{type(self).__name__} {self.name!r} {state}>"


class InstrumentedLock(_InstrumentedBase):
    _reentrant = False


class InstrumentedRLock(_InstrumentedBase):
    _reentrant = True


def make_lock(name: str):
    """A ``threading.Lock`` — instrumented when ``REPRO_LOCK_CHECK=1``."""
    return InstrumentedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — instrumented when ``REPRO_LOCK_CHECK=1``."""
    return InstrumentedRLock(name) if enabled() else threading.RLock()


# -- guarded containers --------------------------------------------------------

class GuardedDict(dict):
    """A dict whose *mutations* assert the guarding lock is held.

    Reads are deliberately unguarded (see module docs).  Only built when
    instrumented-lock mode is on — :func:`guard_dict` returns the plain
    mapping otherwise, so the production path has no indirection."""

    def __init__(self, mapping, lock):
        super().__init__(mapping)
        self._lc_lock = lock

    def _check(self) -> None:
        self._lc_lock.assert_held()

    def __setitem__(self, key, value):
        self._check()
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check()
        super().__delitem__(key)

    def pop(self, *a):
        self._check()
        return super().pop(*a)

    def popitem(self):
        self._check()
        return super().popitem()

    def clear(self):
        self._check()
        super().clear()

    def update(self, *a, **kw):
        self._check()
        super().update(*a, **kw)

    def setdefault(self, key, default=None):
        self._check()
        return super().setdefault(key, default)


def guard_dict(mapping: dict, lock) -> dict:
    """Wrap ``mapping`` so mutations assert ``lock`` is held — when the
    lock is instrumented; otherwise return ``mapping`` unchanged."""
    if isinstance(lock, _InstrumentedBase):
        return GuardedDict(mapping, lock)
    return mapping
