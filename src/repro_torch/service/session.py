"""Interactive sessions: incremental top-k result delivery.

A session wraps any resumable ranking run presenting the uniform
``target / result / n`` surface — :class:`repro_torch.core.engine.TopKRun` or
:class:`repro_torch.core.engine.FilteredTopKRun` (a predicate-filtered ranking
paginates identically; the predicate residue just rides the same frontier).
The GUI's "LIMIT 25 → next 25" interaction becomes: raise the run's
finality target to ``served + k`` (re-deriving the pruning frontier from
the *cached* bounds — no new CHI pass) and run only the extra verification
batches the larger target needs.  Pagination over n pages therefore returns
exactly the ids/scores of a one-shot ``LIMIT n·k`` query, at a fraction of
fresh cost.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import OrderedDict
from typing import Optional

from .errors import NotFoundError

_session_counter = itertools.count(1)


@dataclasses.dataclass
class Session:
    id: str
    sql: str
    run: object                      # TopKRun | FilteredTopKRun
    page_size: int
    kind: str = "topk"
    served: int = 0
    pages_served: int = 0
    done: bool = False               # qualifying result set fully delivered
    created_s: float = dataclasses.field(default_factory=time.monotonic)
    last_used_s: float = dataclasses.field(default_factory=time.monotonic)

    @property
    def exhausted(self) -> bool:
        # ``done`` covers filtered rankings, whose deliverable count is the
        # number of predicate-qualifying rows — discovered during paging —
        # not the candidate count ``run.n``.
        return self.done or self.served >= self.run.n

    def page_bounds(self, k: Optional[int]) -> tuple[int, int]:
        k = self.page_size if k is None else max(int(k), 1)
        return self.served, min(self.served + k, self.run.n)

    def stats(self) -> dict:
        """Per-session progress + phase breakdown (DESIGN.md §10) — what
        ``/stats`` and ``session.stats()`` surface for each live session."""
        s = self.run.stats
        now = time.monotonic()
        return {
            "sql": self.sql[:200], "kind": self.kind,
            "served": self.served, "pages_served": self.pages_served,
            "total_candidates": self.run.n, "exhausted": self.exhausted,
            "age_s": now - self.created_s, "idle_s": now - self.last_used_s,
            "verified": s.n_verified, "bytes_loaded": s.bytes_loaded,
            "bytes_saved": s.bytes_saved,
            "phases": {"bounds_s": s.bound_time_s,
                       "verify_s": s.verify_time_s},
        }


class SessionManager:
    """Holds live sessions with LRU eviction beyond ``max_sessions``."""

    def __init__(self, max_sessions: int = 256):
        self.max_sessions = max_sessions
        self._sessions: OrderedDict[str, Session] = OrderedDict()
        self.created = 0
        self.evicted = 0

    def create(self, sql: str, run, page_size: int,
               kind: str = "topk") -> Session:
        sid = f"s{next(_session_counter)}-{id(run) & 0xffff:04x}"
        sess = Session(id=sid, sql=sql, run=run, kind=kind,
                       page_size=max(int(page_size), 1))
        self._sessions[sid] = sess
        self.created += 1
        while len(self._sessions) > self.max_sessions:
            self._sessions.popitem(last=False)
            self.evicted += 1
        return sess

    def get(self, sid: str) -> Session:
        sess = self._sessions.get(sid)
        if sess is None:
            # NotFoundError (a KeyError subclass) so the HTTP guards can
            # 404 this without treating every engine KeyError as 404.
            raise NotFoundError(f"unknown or expired session {sid!r}")
        self._sessions.move_to_end(sid)
        sess.last_used_s = time.monotonic()
        return sess

    def drop(self, sid: str) -> bool:
        return self._sessions.pop(sid, None) is not None

    def __len__(self) -> int:
        return len(self._sessions)

    def stats(self) -> dict:
        return {"active": len(self._sessions), "created": self.created,
                "evicted": self.evicted,
                "pages_served": sum(s.pages_served
                                    for s in self._sessions.values()),
                "per_session": {sid: s.stats()
                                for sid, s in self._sessions.items()}}
