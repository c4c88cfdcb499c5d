"""Multi-query workloads (the full paper's workload experiments).

ML debugging sessions issue *many* related queries (different thresholds,
value ranges, ROIs) against the same mask DB.  Two optimizations, both from
the paper, both implemented here:

1. **One bounds pass for the whole workload** — the CHI table is read once
   and every query's bounds are computed from it (vectorized over the
   descriptor axis; see ``chi.chi_bounds_multi``).
2. **Shared verification loads** — if several queries need the same mask's
   bytes, the store's cross-query cache pays the I/O once
   (``MaskStore.enable_cache``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from .queries import parse


@dataclasses.dataclass
class WorkloadStats:
    per_query: list  # masklint: ignore[stats-drift] -- report object, not sampled counters
    total_wall_s: float = 0.0
    bytes_loaded: int = 0
    files_loaded: int = 0

    @property
    def total_verified(self):
        return sum(s.n_verified for s in self.per_query)


def run_workload(store, sql_queries: Sequence[str], *, provided_rois=None,
                 use_index: bool = True, share_loads: bool = True):
    """Execute a workload; returns (results, WorkloadStats)."""
    plans = [parse(q) if isinstance(q, str) else q for q in sql_queries]
    # enable_cache is idempotent: only clear on exit if we newly enabled it
    # (the query service may already hold a longer-lived cross-session cache).
    owns_cache = store.enable_cache() if share_loads else False
    files0, bytes0 = store.io.files_read, store.io.bytes_read
    t0 = time.perf_counter()
    results, stats = [], []
    try:
        for plan in plans:
            res, st = plan.run(store, provided_rois=provided_rois,
                               use_index=use_index)
            results.append(res)
            stats.append(st)
    finally:
        if owns_cache:
            store.clear_cache()
    wall = time.perf_counter() - t0
    ws = WorkloadStats(per_query=stats, total_wall_s=wall,
                       bytes_loaded=store.io.bytes_read - bytes0,
                       files_loaded=store.io.files_read - files0)
    return results, ws
