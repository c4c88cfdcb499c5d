"""Admission control for the async serving tier (DESIGN.md §14).

Three mechanisms, composed by :class:`AdmissionController`:

* **Token-bucket quotas** — one bucket per tenant (``rate`` tokens/s,
  ``burst`` capacity).  A request with no token is shed *immediately*
  with :class:`~.errors.RateLimitedError` carrying the exact refill
  wait, which becomes ``Retry-After``.  Quotas bound each tenant's
  admission *rate*; they say nothing about ordering.
* **Bounded per-tenant queues** — admitted work waits in a FIFO per
  tenant, each bounded by ``depth``.  A full queue sheds with
  :class:`~.errors.OverloadedError` instead of queueing unboundedly:
  under overload the tier's memory and tail latency stay flat and the
  client is told when to come back (429 + ``Retry-After``), which is the
  tier's load-shedding contract.
* **Weighted fair dequeue** — the dispatcher drains the queues by
  deficit round robin (DRR): each visit grants a tenant
  ``quantum x weight`` deficit and dequeues while the deficit covers a
  unit cost, so a tenant flooding its own queue cannot starve the
  others, and weights buy proportional throughput, not priority
  inversion.

Everything here runs on the event loop thread (single-threaded by
construction — no locks); only the counters are read cross-thread by the
``/metrics`` scraper, which tolerates torn reads of monotonic ints.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Optional

from .errors import OverloadedError, RateLimitedError

__all__ = ["TokenBucket", "FairQueue", "AdmissionController",
           "AdmissionStats"]


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill toward ``burst``."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float):
        self.rate = max(float(rate), 1e-9)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self.t_last: Optional[float] = None

    def try_take(self, now: float, n: float = 1.0) -> float:
        """Take ``n`` tokens.  → 0.0 when granted, else the seconds until
        enough tokens will have refilled (the honest Retry-After)."""
        if self.t_last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


class FairQueue:
    """Bounded per-tenant FIFOs drained by deficit round robin."""

    def __init__(self, depth: int = 256, weights: Optional[dict] = None,
                 quantum: float = 1.0):
        self.depth = max(int(depth), 1)
        self.weights = dict(weights or {})
        self.quantum = float(quantum)
        self._queues: OrderedDict[str, deque] = OrderedDict()
        self._deficit: dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        return max(float(self.weights.get(tenant, 1.0)), 1e-3)

    def push(self, tenant: str, item, *, force: bool = False) -> bool:
        """Enqueue; ``False`` when the tenant's FIFO is at depth (the
        caller sheds).  ``force`` exempts already-admitted work — e.g.
        the continuation pages of a streaming session, which must never
        be shed mid-stream."""
        q = self._queues.get(tenant)
        if q is None:
            q = deque()
            self._queues[tenant] = q
            self._deficit[tenant] = 0.0
        if not force and len(q) >= self.depth:
            return False
        q.append(item)
        return True

    def depth_of(self, tenant: str) -> int:
        q = self._queues.get(tenant)
        return len(q) if q is not None else 0

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pop_batch(self, max_items: int) -> list:
        """Dequeue up to ``max_items`` as (tenant, item) pairs, DRR-fair
        across the tenants with pending work."""
        batch: list = []
        if max_items <= 0:
            return batch
        pending = True
        while len(batch) < max_items and pending:
            pending = False
            for tenant in list(self._queues):
                q = self._queues[tenant]
                if not q:
                    # empty queue forfeits its accumulated deficit (DRR:
                    # credit never carries across idle periods)
                    self._deficit[tenant] = 0.0
                    continue
                self._deficit[tenant] += self.quantum * self.weight(tenant)
                while q and self._deficit[tenant] >= 1.0 \
                        and len(batch) < max_items:
                    batch.append((tenant, q.popleft()))
                    self._deficit[tenant] -= 1.0
                if q:
                    pending = True
                if len(batch) >= max_items:
                    break
            # a nonempty queue accrues deficit every cycle, so the loop
            # always progresses toward either max_items or empty queues
            pending = pending or any(len(q) for q in self._queues.values())
            if not pending:
                break
        return batch


@dataclasses.dataclass
class AdmissionStats:
    admitted: int = 0
    shed_rate_limited: int = 0   # no token in the tenant's bucket
    shed_queue_full: int = 0     # tenant FIFO at depth
    forced: int = 0              # depth-exempt continuation work

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdmissionController:
    """Per-tenant token buckets in front of the weighted-fair queue."""

    def __init__(self, *, rate: float = 500.0, burst: float = 250.0,
                 depth: int = 256, weights: Optional[dict] = None,
                 quantum: float = 1.0, clock=time.monotonic):
        self.rate = rate
        self.burst = burst
        self.clock = clock
        self.queue = FairQueue(depth=depth, weights=weights, quantum=quantum)
        self.stats = AdmissionStats()
        self._buckets: dict[str, TokenBucket] = {}

    def bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = TokenBucket(self.rate, self.burst)
            self._buckets[tenant] = b
        return b

    def charge(self, tenant: str, n: float = 1.0) -> None:
        """Debit the tenant's bucket without queueing (mutations and other
        directly-executed work).  Sheds with the exact refill wait."""
        wait = self.bucket(tenant).try_take(self.clock(), n)
        if wait > 0.0:
            self.stats.shed_rate_limited += 1
            raise RateLimitedError(
                f"tenant {tenant!r} over quota ({self.rate:g}/s, "
                f"burst {self.burst:g})", wait)

    def admit(self, tenant: str, item, *, force: bool = False) -> None:
        """Charge the bucket and enqueue, or shed with a 429-mapped
        error.  ``force`` bypasses both bounds (continuation work of an
        already-admitted request)."""
        if force:
            self.queue.push(tenant, item, force=True)
            self.stats.forced += 1
            return
        # capacity check before the bucket so a queue-full shed does not
        # also waste one of the tenant's tokens
        if self.queue.depth_of(tenant) >= self.queue.depth:
            self.stats.shed_queue_full += 1
            # time for the dispatcher to drain one slot, roughly: the
            # tenant's whole backlog over its fair admission rate
            retry = min(max(self.queue.depth / max(self.rate, 1.0), 0.05),
                        5.0)
            raise OverloadedError(
                f"tenant {tenant!r} queue full "
                f"(depth {self.queue.depth})", retry)
        self.charge(tenant)
        self.queue.push(tenant, item, force=True)
        self.stats.admitted += 1
