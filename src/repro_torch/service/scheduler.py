"""Cross-query verification scheduler — the multi-query optimization online.

Admitted jobs (filter or top-k runs from any number of in-flight sessions)
are driven round-robin; each round the scheduler

1. pops one ``verify_batch`` of undecided candidates from every live job,
2. loads the **union** of their mask positions once through the store's
   shared-load cache (overlapping residues pay I/O once), and
3. answers every job's CP descriptors in **one fused kernel pass** via
   ``kernels.ops.cp_count_multi`` — Q descriptors over one read of the mask
   bytes, the full paper's workload optimization applied across concurrent
   sessions instead of a pre-declared batch.

Dual-mask (pair) jobs fuse with each other the same way: the union of
their per-image (role_a, role_b) row pairs is loaded once and every
distinct (rois, ta, tb) pair descriptor is answered across all jobs in one
dual-mask kernel pass per descriptor (``_fused_pair_pass``).  Jobs whose
expressions can't be fused either way (MASK_AGG group queries) fall back
to their own verification path, still behind the shared cache, so they
share I/O even when they can't share compute.

The scheduler is operator-agnostic: any run implementing the uniform
``take_batch / cp_terms / fused_values / apply_exact / finished`` interface
(filter, top-k, filtered top-k, scalar aggregation — see DESIGN.md §6)
fuses here without the scheduler knowing which it is driving.  It is also
backend-agnostic: the fused pass runs on whichever
:class:`repro_torch.core.backend.ExecBackend` owns the store — the host path
loads the union through the shared-load cache; the device path reads it
in place from the HBM-resident tier (``cp_count_multi`` /
``cp_count_multi_packed`` through positions).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.backend import F32_MAX as _F32_MAX
from ..core.backend import get_backend
from ..core.exprs import CP, MaskEvalContext, PairEvalContext, PairTerm
from ..obs import trace as _trace


@dataclasses.dataclass
class SchedulerStats:
    rounds: int = 0
    fused_passes: int = 0
    fused_descriptors: int = 0   # CP rows answered by cp_count_multi
    fused_masks: int = 0         # union masks per fused pass, summed
    fused_bytes_loaded: int = 0  # exact shared-load bytes across passes
    fused_time_s: float = 0.0
    pair_passes: int = 0         # fused dual-mask passes
    pair_descriptors: int = 0    # (rois, ta, tb) pair specs answered
    pair_pairs: int = 0          # union mask pairs per pair pass, summed
    fallback_batches: int = 0
    # Cross-tenant fusion (the async tier's multi-user batching): passes
    # whose participating jobs span more than one tenant, the jobs that
    # rode them, and the distinct-tenant width summed over every fused
    # pass (avg width = fused_tenant_width / (fused_passes + pair_passes)).
    cross_tenant_passes: int = 0
    cross_tenant_jobs: int = 0
    fused_tenant_width: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fusable(job) -> bool:
    """A job fuses iff its verification evaluates pure per-mask CP terms
    and it is still fresh — a stale run (store mutated past its pinned
    epoch) must verify through its own epoch-pinned snapshot, not the
    store's current bytes."""
    if not isinstance(job.ctx, MaskEvalContext):
        return False
    if not job.fresh():
        return False
    terms = job.cp_terms()
    return bool(terms) and all(isinstance(t, CP) for t in terms)


def _spec_key(job, term) -> tuple:
    """Cross-job dedup key for one term's kernel descriptor: the term's
    value fields plus the identity of the ROI source when the term uses
    caller-provided boxes (those resolve against each job's own array, so
    they share a row only within one ROI source).  Single definition for
    both the CP and the pair pass — the key must never diverge between
    the build and slice loops."""
    roi_src = id(job.ctx.provided_rois) if term.roi == "provided" else None
    if isinstance(term, PairTerm):
        return (term.ta, term.tb, term.roi, roi_src)
    return (term, roi_src)


def _apportion(total: int, weights) -> list:
    """Split integer ``total`` proportionally to ``weights`` so the shares
    sum to exactly ``total`` (largest-remainder method, deterministic
    tie-break by position)."""
    total = int(total)
    wsum = sum(weights)
    if wsum <= 0 or total <= 0:
        return [0] * len(weights)
    raw = [total * w / wsum for w in weights]
    shares = [int(r) for r in raw]
    rest = total - sum(shares)
    order = sorted(range(len(weights)), key=lambda i: raw[i] - shares[i],
                   reverse=True)
    for i in order[:rest]:
        shares[i] += 1
    return shares


def _pair_fusable(job) -> bool:
    """Dual-mask jobs fuse with each other: same freshness contract, pure
    pair-term verification over a :class:`PairEvalContext`."""
    if not isinstance(job.ctx, PairEvalContext):
        return False
    if not job.fresh():
        return False
    terms = job.cp_terms()
    return bool(terms) and all(isinstance(t, PairTerm) for t in terms)


class FusedScheduler:
    """Drives a set of FilterRun/TopKRun jobs to completion concurrently.

    Round size is each run's own ``verify_batch`` — the scheduler only
    sequences and fuses the batches the runs produce."""

    def __init__(self, store, backend=None):
        self.store = store
        self.backend = get_backend(store, backend)
        self.stats = SchedulerStats()
        # id(job) -> tenant for the drive in flight (drives run under the
        # service lock, so one map at a time is safe).
        self._tenant_of: dict = {}

    def _note_tenants(self, pairs, span) -> None:
        """Account one fused pass's tenant mix: distinct-tenant width and,
        when jobs from different tenants merged into the same kernel pass
        (the async tier's cross-tenant batching), the cross-tenant
        counters.  Untagged jobs all count as one anonymous tenant."""
        tenants = {self._tenant_of.get(id(j), "") for j, _ in pairs}
        self.stats.fused_tenant_width += len(tenants)
        if len(tenants) > 1:
            self.stats.cross_tenant_passes += 1
            self.stats.cross_tenant_jobs += len(pairs)
        span.set(tenants=len(tenants))

    def drive(self, jobs, tenants=None) -> None:
        """Run every job to its finality target, fusing verification.

        ``tenants`` (optional, aligned with ``jobs``) tags each job with
        the tenant that submitted it so the stats can attribute fusion
        *across* tenants — the async tier's admission batches are the
        caller that exercises this."""
        if tenants is not None:
            self._tenant_of = {id(j): t for j, t in zip(jobs, tenants)
                               if j is not None}
        else:
            self._tenant_of = {}
        jobs = [j for j in jobs if j is not None]
        owns_cache = self.store.enable_cache()
        try:
            while True:
                takes = []
                for job in jobs:
                    if job.finished():
                        continue
                    batch = job.take_batch()
                    if len(batch):
                        takes.append((job, batch))
                if not takes:
                    break
                self.stats.rounds += 1
                fused = [(j, b) for j, b in takes if _fusable(j)]
                pair_fused = [(j, b) for j, b in takes if _pair_fusable(j)]
                direct = [(j, b) for j, b in takes
                          if not (_fusable(j) or _pair_fusable(j))]
                if fused:
                    self._fused_pass(fused)
                if pair_fused:
                    self._fused_pair_pass(pair_fused)
                for job, batch in direct:
                    self.stats.fallback_batches += 1
                    job.self_verify(batch)
        finally:
            self._tenant_of = {}
            if owns_cache:
                self.store.clear_cache()

    # -- the fused kernel pass -------------------------------------------
    def _fused_pass(self, pairs) -> None:
        store = self.store
        all_pos = np.unique(np.concatenate(
            [j.ctx.positions[b] for j, b in pairs]))
        io0 = store.io.bytes_read
        saved0 = store.cache_stats.bytes_saved
        t0 = time.perf_counter()

        with _trace.span("scheduler.fused_pass") as sp:
            # Dedupe CP descriptors across jobs.  CP nodes hash by value, so
            # two sessions ranking by the same term share one kernel row
            # (see _spec_key for the "provided"-ROI caveat).
            rows: dict = {}
            specs: list = []
            for job, _ in pairs:
                for term in set(job.cp_terms()):
                    key = _spec_key(job, term)
                    if key not in rows:
                        rois = job.ctx.resolve_rois(term.roi, all_pos)
                        rows[key] = len(specs)
                        specs.append((rois, term.lv, min(term.uv, _F32_MAX)))
            counts = self.backend.fused_counts(store, all_pos, specs)

            self.stats.fused_passes += 1
            self.stats.fused_descriptors += len(specs)
            self.stats.fused_masks += len(all_pos)
            self._note_tenants(pairs, sp)

            for job, batch in pairs:
                pos = job.ctx.positions[batch]
                sub = np.searchsorted(all_pos, pos)
                cdict = {}
                for term in set(job.cp_terms()):
                    cdict[term] = counts[rows[_spec_key(job, term)]][sub]
                job.apply_exact(batch, job.fused_values(batch, cdict))
            sp.set(jobs=len(pairs), descriptors=len(specs),
                   union_masks=len(all_pos),
                   bytes_loaded=store.io.bytes_read - io0,
                   bytes_saved=store.cache_stats.bytes_saved - saved0)

        # Per-job ExecStats get a fair share of the round's shared load and
        # wall time (proportional to batch size); the exact aggregate lives
        # in SchedulerStats.fused_bytes_loaded / fused_time_s.
        self._account(pairs, store.io.bytes_read - io0,
                      store.cache_stats.bytes_saved - saved0,
                      time.perf_counter() - t0)

    def _account(self, pairs, bytes_delta: int, saved_delta: int,
                 elapsed: float) -> None:
        """Attribute one fused round's *metered* bytes and wall time to the
        participating runs, proportional to batch size.  The byte
        apportionment is exact (largest remainder), so the sum of per-run
        ``bytes_loaded`` equals the store's metered delta — never the
        truncation drift of per-job ``int(delta * share)``.  Bytes the
        shared-load cache served count once globally (the store meters only
        misses) and are attributed per run as ``bytes_saved``."""
        self.stats.fused_bytes_loaded += bytes_delta
        self.stats.fused_time_s += elapsed
        weights = [len(b) for _, b in pairs]
        for (job, batch), share_bytes, share_saved in zip(
                pairs, _apportion(bytes_delta, weights),
                _apportion(saved_delta, weights)):
            job.stats.bytes_loaded += share_bytes
            job.stats.bytes_saved += share_saved
            job.stats.verify_time_s += \
                elapsed * len(batch) / max(sum(weights), 1)

    # -- the fused dual-mask pass ----------------------------------------
    def _fused_pair_pass(self, pairs) -> None:
        """One fused pass over the union of the jobs' pair batches: load
        the union of (pos_a, pos_b) rows once (shared-load cache), answer
        every distinct (rois, ta, tb) pair descriptor across all jobs, and
        hand each job its slice — the cross-query analogue of the single
        job's ``pair_verify_counts`` route."""
        store = self.store

        def keys_of(job, batch):
            ctx = job.ctx
            return (ctx.pos_a[batch].astype(np.int64) << 32) | \
                ctx.pos_b[batch].astype(np.int64)

        all_keys = np.unique(np.concatenate(
            [keys_of(j, b) for j, b in pairs]))
        u_pa = (all_keys >> 32).astype(np.int64)
        u_pb = (all_keys & 0xffffffff).astype(np.int64)
        io0 = store.io.bytes_read
        saved0 = store.cache_stats.bytes_saved
        t0 = time.perf_counter()

        with _trace.span("scheduler.pair_pass") as sp:
            rows: dict = {}
            specs: list = []
            for job, _ in pairs:
                for term in set(job.cp_terms()):
                    key = _spec_key(job, term)
                    if key not in rows:
                        rows[key] = len(specs)
                        specs.append(
                            (job.ctx.resolve_pair_rois(term.roi, u_pa),
                             term.ta, term.tb))
            counts = self.backend.fused_pair_counts(store, u_pa, u_pb, specs)

            self.stats.pair_passes += 1
            self.stats.pair_descriptors += len(specs)
            self.stats.pair_pairs += len(all_keys)
            self._note_tenants(pairs, sp)

            stat_row = self.backend.PAIR_STAT_ROW
            for job, batch in pairs:
                sub = np.searchsorted(all_keys, keys_of(job, batch))
                cdict = {}
                for term in set(job.cp_terms()):
                    cdict[term] = np.asarray(
                        counts[rows[_spec_key(job, term)],
                               stat_row[term.stat]], np.float64)[sub]
                job.apply_exact(batch, job.fused_values(batch, cdict))
            sp.set(jobs=len(pairs), descriptors=len(specs),
                   union_pairs=len(all_keys),
                   bytes_loaded=store.io.bytes_read - io0,
                   bytes_saved=store.cache_stats.bytes_saved - saved0)

        self._account(pairs, store.io.bytes_read - io0,
                      store.cache_stats.bytes_saved - saved0,
                      time.perf_counter() - t0)
