"""Pluggable execution backends — one physical filter–verification layer.

The engine's run objects (:mod:`.engine`) are *drivers*: they own the
frontier bookkeeping (what is decided, what is pending, when a ranking is
final) but delegate every physical operation to an :class:`ExecBackend`.
Four primitives cover every plan the IR can express:

* ``bounds(ctx, expr)``            — CHI-derived (lb, ub) for every
                                     candidate of a value expression (the
                                     filter phase; no mask bytes touched).
* ``verify_counts(ctx, batch, terms)`` — exact per-CP-term pixel counts for
                                     one verification batch (the
                                     verification phase).
* ``topk_candidates(lb, ub, k, …)`` — the ranking frontier: which
                                     candidates can still reach the top-k.
* ``mask_agg_counts(gctx, node, gidx)`` — fused thresholded
                                     intersection/union counts for MASK_AGG
                                     group verification.

plus ``fused_counts`` — the service scheduler's cross-query
``cp_count_multi`` pass, run on whichever backend owns the store — and,
for packed stores, ``fused_verify_counts``: the bounds+verify megakernel
route, one launch per verification batch.  Dual-mask (pair) plans add
``fused_pair_counts``: Q ``(rois, ta, tb)`` descriptors over per-image
mask pairs → inter / union / diff counts, one ``pair_counts`` (or
``pair_counts_packed``) launch per descriptor; ``pair_verify_counts``
groups a batch's pair terms by descriptor so IoU's inter and union share
one launch.

Packed stores (DESIGN.md §12) run the same primitives on the popcount
kernels; their words reach torch as the int32 bit view of the store's
uint32 words (``packing.torch_bits``).

Three implementations:

* :class:`HostBackend`   — the NumPy/``MaskEvalContext`` paths: metered
                           ``store.load`` (partial ROI-row loads, shared-load
                           cache, I/O metering); each verification batch is
                           moved to the store's device and counted there by
                           the ``cp_count`` kernel.
* :class:`DeviceBackend` — the store's mask bytes and CHI table resident on
                           the store's device; bounds *and* verification
                           run there (torch ops plus the CUDA kernels), so
                           the filter phase leaves the host — pair bounds
                           included (both roles' CHI rows gathered and
                           combined cell by cell on the device).
* :class:`MeshBackend`   — every primitive is a step of
                           :mod:`.distributed`, rows sharded over a device
                           mesh (its shards may repeat one device); each
                           step gathers its rows from the store's
                           host-resident arrays and places them on the
                           shards, where the same kernels run.

Equivalence contract: every backend returns identical ids/scores and
identical ``n_verified`` accounting for any plan.  Bounds interval
arithmetic stays on the host in float64 for every backend (only the CP
leaf differs, and it is integral), and the device top-k returns the τ *row
id* rather than a float32 τ value, so the frontier comparison happens at
full host precision everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import cuda_lib
from ..kernels import ops as kops
from ..obs.metrics import REGISTRY as _REG
from . import packing
from .distributed import (_bounds_from_corners, device_resolve,
                          local_devices, make_chi_bounds_step,
                          make_cp_multi_packed_step, make_cp_multi_step,
                          make_fused_verify_step, make_mask_agg_packed_step,
                          make_mask_agg_step, make_mesh,
                          make_pair_cells_step, make_pair_counts_packed_step,
                          make_pair_counts_step, make_topk_select_step,
                          make_verify_packed_step, make_verify_step,
                          pair_cells, value_ks)
from .exprs import _threshold_ks

F32_MAX = 3.4e38  # finite stand-in for +inf in float32 kernel compares

_BACKEND_RESOLUTIONS = _REG.counter(
    "masksearch_backend_resolutions_total",
    "get_backend() resolutions by resolved backend", ("backend",))
_BACKEND_BUILDS = _REG.counter(
    "masksearch_backend_constructions_total",
    "Named backend instances constructed (the resident mask/CHI upload "
    "happens here)", ("backend",))
_BACKEND_SYNCS = _REG.counter(
    "masksearch_backend_syncs_total",
    "Epoch re-pins of resident backend state after store mutations",
    ("backend",))


def spec_arrays(specs, dtype=np.float32):
    """Stack fused-pass descriptors ``(rois, lv, uv)`` into kernel inputs,
    clamping +inf upper values to the float32-safe ceiling — the one
    canonical layout shared by every backend and the service scheduler."""
    rois_q = np.stack([s[0] for s in specs]).astype(np.int32)
    lvs = np.asarray([s[1] for s in specs], dtype)
    uvs = np.asarray([min(s[2], F32_MAX) for s in specs], dtype)
    return rois_q, lvs, uvs


def is_packed(store) -> bool:
    """Whether a store serves the bitpacked binary-mask tier (DESIGN.md §12).

    ``getattr`` so snapshots, stores predating the tier, and test doubles
    all read as float."""
    return bool(getattr(store, "packed", False))


def _device_of(store) -> torch.device:
    return getattr(store, "device", torch.device("cpu"))


def _to(arr, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (no copy for a CPU device;
    packed uint32 words as their int32 bit view)."""
    return torch.from_numpy(packing.torch_bits(arr)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def chi_verdicts(terms, batch: np.ndarray, bounds_of):
    """Assemble the megakernel's CHI-verdict inputs from memoized bounds.

    ``bounds_of(term) -> (lb, ub) | None`` is a *memo-only* getter: a term
    whose filter-phase bounds were never computed returns None and is simply
    treated as undecided everywhere — always correct, never an extra bounds
    pass.  Returns ``decided`` (Q, B) int32 0/1 and ``lb`` (Q, B) int32
    aligned with ``terms`` × ``batch``."""
    q, b = len(terms), len(batch)
    decided = np.zeros((q, b), np.int32)
    lb_out = np.zeros((q, b), np.int32)
    for i, t in enumerate(terms):
        bnd = bounds_of(t) if bounds_of is not None else None
        if bnd is None:
            continue
        tlb = np.asarray(bnd[0])[batch]
        tub = np.asarray(bnd[1])[batch]
        eq = tlb == tub
        decided[i] = eq
        lb_out[i] = np.where(eq, tlb, 0)
    return decided, lb_out


class ExecBackend:
    """Protocol for the physical layer under the engine's run drivers."""

    name = "abstract"

    def sync(self) -> None:
        """Refresh any store-resident state (pinned masks, CHI tables) to
        the store's current epoch.  Called by :func:`get_backend` on every
        resolution, so a backend instance cached across mutations never
        serves pre-epoch residency.  Host is stateless — no-op."""

    def bounds(self, ctx, expr):
        """(lb, ub) float64 arrays over ``ctx``'s candidates for ``expr``."""
        raise NotImplementedError

    def verify_counts(self, ctx, batch: np.ndarray, terms) -> dict:
        """Exact counts for one verification batch: CP term → float64
        array aligned with ``batch`` (candidate indices into ``ctx``)."""
        raise NotImplementedError

    def topk_candidates(self, lb, ub, k: int, desc: bool,
                        definite: np.ndarray,
                        possible: np.ndarray) -> np.ndarray:
        """The static pruning frontier: candidates whose optimistic bound
        beats the k-th best pessimistic bound among ``definite``
        (definitely-qualifying) candidates.  Returns an ``alive`` bool
        array ⊆ ``possible``; when fewer than k are definite nothing can
        be pruned and ``possible`` is returned unchanged."""
        raise NotImplementedError

    def mask_agg_counts(self, gctx, node, gidx: np.ndarray) -> np.ndarray:
        """Exact MASK_AGG counts (thresholded intersect/union inside the
        ROI) for group indices ``gidx`` of a :class:`GroupEvalContext`."""
        raise NotImplementedError

    def fused_verify_counts(self, ctx, batch: np.ndarray, terms,
                            bounds_of=None) -> dict:
        """The bounds+verify megakernel route (packed stores, DESIGN.md
        §12): one launch answers *every* CP descriptor of a verification
        batch — CHI-decided (term, mask) entries (memoized lb == ub) pass
        their bound straight through, the undecided remainder is counted
        from the packed words.  ``bounds_of(term) -> (lb, ub) | None`` is a
        memo-only getter over the run's filter-phase bounds; None →
        undecided (always correct).  Float stores take the classic
        per-term :meth:`verify_counts` path, so drivers can call this
        unconditionally."""
        terms = list(terms)
        if not is_packed(getattr(ctx, "store", None)):
            return self.verify_counts(ctx, batch, terms)
        batch = np.asarray(batch)
        pos = ctx.positions[batch]
        rois_q, lvs, uvs = spec_arrays(
            [(ctx.resolve_rois(t.roi, pos), t.lv, t.uv) for t in terms])
        decided, lb = chi_verdicts(terms, batch, bounds_of)
        counts = self._fused_verify_batch(ctx, batch, pos, rois_q, lvs, uvs,
                                          decided, lb)
        return {t: np.asarray(counts[i], np.float64)
                for i, t in enumerate(terms)}

    def _fused_verify_batch(self, ctx, batch, pos, rois_q, lvs, uvs,
                            decided, lb) -> np.ndarray:
        """Physical megakernel dispatch: packed batch rows + assembled
        descriptors/verdicts → (Q, B) int32 exact counts."""
        raise NotImplementedError

    def fused_counts(self, store, positions: np.ndarray,
                     specs) -> np.ndarray:
        """The scheduler's fused pass: Q ``(rois, lv, uv)`` descriptors
        over the masks at ``positions`` → (Q, B) counts from one pass
        over the bytes."""
        raise NotImplementedError

    PAIR_STAT_ROW = {"inter": 0, "union": 1, "diff": 2}

    def fused_pair_counts(self, store, pos_a: np.ndarray, pos_b: np.ndarray,
                          specs) -> np.ndarray:
        """Dual-mask pass: Q ``(rois, ta, tb)`` descriptors over the
        per-image mask pairs ``(pos_a[i], pos_b[i])`` → (Q, 3, B) counts —
        rows indexed by :attr:`PAIR_STAT_ROW` (inter / union / diff=|A∖B|).
        All three stats come from one kernel launch per descriptor."""
        raise NotImplementedError

    def pair_verify_counts(self, pctx, batch: np.ndarray, terms) -> dict:
        """Exact pair-term counts for one verification batch: pair term →
        float64 array aligned with ``batch`` (candidate indices into
        ``pctx``).  Terms sharing a (ta, tb, roi) pair spec — e.g. IoU's
        intersection and union — are answered by a single kernel launch.
        Shared by every backend; the physical pass is
        :meth:`fused_pair_counts`."""
        batch = np.asarray(batch)
        spec_ix: dict = {}
        specs: list = []
        for t in terms:
            key = (t.ta, t.tb, t.roi)
            if key not in spec_ix:
                spec_ix[key] = len(specs)
                specs.append((pctx.pair_rois(t.roi, batch), t.ta, t.tb))
        counts = self.fused_pair_counts(pctx.store, pctx.pos_a[batch],
                                        pctx.pos_b[batch], specs)
        return {t: np.asarray(counts[spec_ix[(t.ta, t.tb, t.roi)],
                                     self.PAIR_STAT_ROW[t.stat]], np.float64)
                for t in terms}


# ---------------------------------------------------------------------------
# Host — the NumPy / MaskEvalContext physical layer
# ---------------------------------------------------------------------------


class HostBackend(ExecBackend):
    """The original physical layer: bounds through the store's CHI gather,
    verification through metered ``store.load`` (partial ROI-row loads,
    shared-load cache) + the ``cp_count`` kernel on the store's device,
    frontiers in NumPy."""

    name = "host"

    def bounds(self, ctx, expr):
        return ctx.bounds(expr)

    def verify_counts(self, ctx, batch, terms):
        # One ctx.exact per *distinct* term: masks_for caches the load, so
        # a predicate and a ranking sharing an expression share its bytes.
        return {t: ctx.exact(t, batch) for t in terms}

    def topk_candidates(self, lb, ub, k, desc, definite, possible):
        if desc:
            dvals = lb[definite]
            if len(dvals) >= k:
                tau = np.partition(dvals, -k)[-k]
                return possible & (ub >= tau)
            return possible.copy()
        dvals = ub[definite]
        if len(dvals) >= k:
            tau = np.partition(dvals, k - 1)[k - 1]
            return possible & (lb <= tau)
        return possible.copy()

    def mask_agg_counts(self, gctx, node, gidx):
        gidx = np.asarray(gidx)
        s = gctx.groups.shape[1]
        flat_idx = (gidx[:, None] * s + np.arange(s)[None, :]).reshape(-1)
        masks = gctx._ctx.masks_for(flat_idx)
        # row shape is (H, W) float or (H, words) packed — keep it as-is
        masks = masks.reshape((len(gidx), s) + masks.shape[1:])
        rois = gctx.resolve_group_rois(node.roi, gidx)
        # fused threshold+agg+count → the CUDA kernel on the card
        kernel = (kops.mask_agg_counts_packed if is_packed(gctx.store)
                  else kops.mask_agg_counts)
        dev = _device_of(gctx.store)
        inter, union = kernel(_to(masks, dev), _to(rois, dev), node.thresh)
        counts = inter if node.agg == "intersect" else union
        return _host(counts).astype(np.float64)

    def fused_counts(self, store, positions, specs):
        masks = store.load(positions)
        dev = _device_of(store)
        if is_packed(store):
            # lv/uv stay on the host: the wrapper turns them into flags
            rois_q, lvs, uvs = spec_arrays(specs)
            return _host(kops.cp_count_multi_packed(
                _to(masks, dev), _to(rois_q, dev), lvs, uvs))
        # lv/uv stay on the host: the wrapper rounds them to the mask dtype
        rois_q, lvs, uvs = spec_arrays(specs, masks.dtype)
        return _host(kops.cp_count_multi(_to(masks, dev), _to(rois_q, dev),
                                         lvs, uvs))

    def fused_pair_counts(self, store, pos_a, pos_b, specs):
        # One metered load of the *union* of both roles' rows — a mask
        # shared by several pairs (or both roles) pays its bytes once.
        pos_a, pos_b = np.asarray(pos_a), np.asarray(pos_b)
        upos = np.unique(np.concatenate([pos_a, pos_b]))
        loaded = _to(store.load(upos), _device_of(store))
        a = loaded[_to(np.searchsorted(upos, pos_a), loaded.device)]
        b = loaded[_to(np.searchsorted(upos, pos_b), loaded.device)]
        return _pair_passes(a, b, specs, is_packed(store))

    def _fused_verify_batch(self, ctx, batch, pos, rois_q, lvs, uvs,
                            decided, lb):
        # masks_for meters the load (in packed bytes) and shares rows with
        # any other term touching the same candidates.
        # The descriptors, verdicts and bounds stay host arrays: the wrapper
        # stages them in one copy.
        return _host(kops.fused_bounds_verify(
            _to(ctx.masks_for(batch), _device_of(ctx.store)), rois_q, lvs,
            uvs, decided, lb))


# ---------------------------------------------------------------------------
# Device — single device, masks + CHI resident in its memory
# ---------------------------------------------------------------------------


def _device_cp_bounds(tables, pos, rois, rb, cb, ks):
    """CP-leaf bounds with the candidate gather, corner resolution and
    8-corner lookup all on the device (the filter phase leaving the host).
    The tier is implicit in the operands: ``device_resolve`` derives the
    grid from ``rb``'s length."""
    corners, area = device_resolve(rois, rb, cb)
    return _bounds_from_corners(tables[pos], corners, area,
                                int(ks[0]), int(ks[1]), int(ks[2]),
                                int(ks[3]))


def _device_multi_counts(masks, pos, rois_q, lvs, uvs):
    """Answer Q CP descriptors over the verification batch ``pos`` of the
    resident mask array in one fused kernel pass, which reads the rows in
    place (no gather); ``lvs``/``uvs`` stay host arrays."""
    return kops.cp_count_multi(masks, rois_q, lvs, uvs, pos)


def _device_kth_index(pes, definite, k: int) -> int:
    masked = torch.where(definite, pes,
                         torch.full_like(pes, float("-inf")))
    return int(torch.topk(masked, k).indices[k - 1])


def _device_group_counts(masks, flat_pos, rois, thresh, s: int):
    grp = masks[flat_pos]
    n = flat_pos.shape[0] // s
    grp = grp.reshape(n, s, masks.shape[1], masks.shape[2])
    return kops.mask_agg_counts(grp, rois, thresh)


def _device_multi_counts_packed(packed, pos, rois_q, lvs, uvs):
    """Packed-tier sibling of :func:`_device_multi_counts`: the kernel reads
    the batch's rows of the resident words in place (no gather).  ``pos``,
    ``rois_q`` and ``lvs``/``uvs`` are host arrays; the wrapper stages them,
    with the flags it makes of ``lvs``/``uvs``, in one copy."""
    return kops.cp_count_multi_packed(packed, rois_q, lvs, uvs, pos)


def _device_group_counts_packed(packed, flat_pos, rois, thresh, s: int):
    grp = packed.index_select(0, flat_pos)
    n = flat_pos.shape[0] // s
    grp = grp.reshape(n, s, packed.shape[1], packed.shape[2])
    return kops.mask_agg_counts_packed(grp, rois, thresh)


def _pair_passes(a, b, specs, packed: bool, pos_a=None,
                 pos_b=None) -> np.ndarray:
    """Q pair descriptors ``(rois, ta, tb)`` over the role rows ``a`` / ``b``
    → (Q, 3, B) int64 counts, one kernel launch each and one copy to the
    host for the pass.  With ``pos_a`` / ``pos_b`` (packed only) the roles
    are rows ``pos_a`` of ``a`` and ``pos_b`` of ``b``, read in place.  The
    float kernel compares in the mask dtype; the packed one takes flags
    from float32-rounded thresholds (the wrappers do both)."""
    kernel = kops.pair_counts_packed if packed else kops.pair_counts
    where = () if pos_a is None else (pos_a, pos_b)
    n = a.shape[0] if pos_a is None else pos_a.shape[0]
    if not specs:
        return np.empty((0, 3, n), np.int64)
    outs = [torch.stack(kernel(a, b, cuda_lib.to_card(
        np.asarray(rois, np.int32), a.device), ta, tb, *where))
            for rois, ta, tb in specs]
    return _host(torch.stack(outs)).astype(np.int64)


class _KthValueMixin:
    """Shared τ finalization: the device top-k selects over *float32*
    scores and returns the k-th best row's id; τ itself is then re-derived
    on the host in float64, so the frontier is bit-identical to
    HostBackend's ``np.partition`` path.

    The float32 cast is order-preserving but not injective: scores closer
    than one f32 ulp collapse into a tie class, and the top-k's pick
    within that class is arbitrary (``torch.topk`` and ``lax.top_k`` pick
    differently) — reading its float64 value directly could yield a τ
    *larger* than the true k-th value and over-prune.  So when the selected
    row's f32 score is shared, the exact τ is resolved from the (tiny) tie
    class at float64: it is the m-th largest member, where
    m = k − (#definite scores strictly above the class)."""

    def _alive_from_index(self, lb, ub, k, desc, definite, possible,
                          pes32, tau_idx):
        pes64 = lb if desc else -ub
        if tau_idx >= len(pes64):   # τ fell on a padded −inf row: no pruning
            return possible.copy()
        # Read τ's class through the same masked view the top-k ranked
        # (non-definite rows are −inf there), not the raw score array.
        tau32 = pes32[tau_idx] if definite[tau_idx] else np.float32(-np.inf)
        tie = definite & (pes32 == tau32)
        n_tie = int(np.count_nonzero(tie))
        if n_tie == 0:              # masked −inf pick outside definite
            return possible.copy()
        if n_tie == 1:
            tau = pes64[np.nonzero(tie)[0][0]]
        else:
            m = k - int(np.count_nonzero(definite & (pes32 > tau32)))
            vals = pes64[tie]
            tau = np.partition(vals, len(vals) - m)[len(vals) - m]
        if desc:
            return possible & (ub >= tau)
        return possible & (lb <= -tau)


class DeviceBackend(_KthValueMixin, ExecBackend):
    """Mask bytes + CHI table resident on the store's device; bounds and
    verification run there, over the CUDA kernels on the card."""

    name = "device"

    def __init__(self, store):
        self.store = store
        self.cfg = store.cfg
        self.device = _device_of(store)
        # resident masks: float pixels, or packed words as int32 bit views
        self._packed = is_packed(store)
        self._masks = store.device_masks()
        self._tables = store.chi_table
        self._epoch = getattr(store, "epoch", 0)
        self._rb = self._bounds_tensor(self.cfg.row_bounds)
        self._cb = self._bounds_tensor(self.cfg.col_bounds)
        self._tier_bnds: dict = {}   # tier grid → (row_bounds, col_bounds)

    def _bounds_tensor(self, b) -> torch.Tensor:
        return torch.as_tensor(np.asarray(b, np.int32)).to(self.device)

    def sync(self):
        """Re-pin the resident mask/CHI tensors after a store mutation.  The
        store maintains its device caches incrementally (appends copy only
        the new chunk over, updates scatter in place, deletes gather), so
        this is a reference refresh, not a re-upload."""
        if self._epoch == getattr(self.store, "epoch", 0):
            return
        self._masks = self.store.device_masks()
        self._tables = self.store.chi_table
        self._epoch = self.store.epoch
        _BACKEND_SYNCS.labels(backend=self.name).inc()

    def bounds(self, ctx, expr):
        if hasattr(ctx, "pair_rois"):
            return ctx.bounds(expr, pair_leaf=self._pair_cells)
        return ctx.bounds(expr, cp_leaf=self._cp_bounds)

    def _tier_bounds(self, g: int):
        pair = self._tier_bnds.get(g)
        if pair is None:
            tcfg = self.cfg.for_grid(g)
            pair = (self._bounds_tensor(tcfg.row_bounds),
                    self._bounds_tensor(tcfg.col_bounds))
            self._tier_bnds[g] = pair
        return pair

    def _cp_bounds(self, mctx, node):
        rois = mctx.resolve_rois(node.roi, mctx.positions)
        g = getattr(mctx, "tier", None)
        if g is None or g == self.cfg.grid:
            cfg, tables, rb, cb = self.cfg, self._tables, self._rb, self._cb
        else:
            # coarse ladder rung: the store's device-resident tier table
            # (maintained incrementally across mutations) + tier boundaries
            cfg = self.cfg.for_grid(g)
            tables = self.store.chi_tier_table(g)
            rb, cb = self._tier_bounds(g)
        ks = value_ks(cfg, node.lv, node.uv)
        lb, ub = _device_cp_bounds(
            tables, _to(np.asarray(mctx.positions, np.int64), self.device),
            _to(rois.astype(np.int32), self.device), rb, cb, ks)
        return _host(lb).astype(np.float64), _host(ub).astype(np.float64)

    def _pair_cells(self, pctx, node):
        # both role gathers, the per-cell counts and the cell algebra on
        # the device: the pair filter phase leaves the host like the CP leaf
        ka = _threshold_ks(self.cfg, node.ta)
        kb = _threshold_ks(self.cfg, node.tb)
        lb, ub = pair_cells(
            node.stat, self._tables[_to(pctx.pos_a, self.device)],
            self._tables[_to(pctx.pos_b, self.device)],
            (ka[0], ka[1], kb[0], kb[1]),
            _to(pctx.pair_rois(node.roi).astype(np.int32), self.device),
            self._rb, self._cb)
        return _host(lb), _host(ub)

    def verify_counts(self, ctx, batch, terms):
        terms = list(terms)
        pos = ctx.positions[batch]
        rois_q, lvs, uvs = spec_arrays(
            [(ctx.resolve_rois(t.roi, pos), t.lv, t.uv) for t in terms])
        counts = self._multi_counts(pos, rois_q, lvs, uvs)
        return {t: counts[i].astype(np.float64)
                for i, t in enumerate(terms)}

    def _multi_counts(self, positions, rois_q, lvs, uvs) -> np.ndarray:
        """Q descriptors over the resident rows at ``positions`` → (Q, B)."""
        pos = np.asarray(positions, np.int64)
        if self._packed:
            return _host(_device_multi_counts_packed(self._masks, pos, rois_q,
                                                     lvs, uvs))
        return _host(_device_multi_counts(self._masks,
                                          _to(pos, self.device),
                                          _to(rois_q, self.device), lvs, uvs))

    def _fused_verify_batch(self, ctx, batch, pos, rois_q, lvs, uvs,
                            decided, lb):
        # The megakernel reads the batch's rows of the resident words in
        # place (no gather); its host operands reach the card in one staged
        # copy.
        return _host(kops.fused_bounds_verify(
            self._masks, rois_q, lvs, uvs, decided, lb,
            np.asarray(pos, np.int64)))

    def topk_candidates(self, lb, ub, k, desc, definite, possible):
        if k <= 0 or int(np.count_nonzero(definite)) < k:
            return possible.copy()
        pes32 = (lb if desc else -ub).astype(np.float32)
        tau_idx = _device_kth_index(
            _to(pes32, self.device),
            _to(np.asarray(definite, bool), self.device), k)
        return self._alive_from_index(lb, ub, k, desc, definite, possible,
                                      pes32, tau_idx)

    def mask_agg_counts(self, gctx, node, gidx):
        gidx = np.asarray(gidx)
        s = gctx.groups.shape[1]
        flat = gctx.groups[gidx].reshape(-1)
        rois = gctx.resolve_group_rois(node.roi, gidx)
        group_counts = (_device_group_counts_packed if self._packed
                        else _device_group_counts)
        inter, union = group_counts(
            self._masks, _to(np.asarray(flat, np.int64), self.device),
            _to(rois.astype(np.int32), self.device), node.thresh, int(s))
        counts = inter if node.agg == "intersect" else union
        return _host(counts).astype(np.float64)

    def fused_counts(self, store, positions, specs):
        return self._multi_counts(positions, *spec_arrays(specs))

    def fused_pair_counts(self, store, pos_a, pos_b, specs):
        # Both roles are resident (the store's one mask tensor), so zero
        # metered bytes: packed words are read in place through the two
        # position lists; float masks gather each role once, whatever Q is.
        pos = cuda_lib.to_card(np.stack([np.asarray(pos_a, np.int64),
                                         np.asarray(pos_b, np.int64)]),
                               self.device)
        if self._packed:
            return _pair_passes(self._masks, self._masks, specs, True,
                                pos[0], pos[1])
        return _pair_passes(self._masks.index_select(0, pos[0]),
                            self._masks.index_select(0, pos[1]), specs,
                            False)


# ---------------------------------------------------------------------------
# Mesh — distributed.py's step functions over the shards of a device mesh
# ---------------------------------------------------------------------------


class MeshBackend(_KthValueMixin, ExecBackend):
    """The query engine sharded over a device mesh: every physical
    primitive is one of :mod:`.distributed`'s step functions, rows sharded
    over the flattened mesh.  Candidate sets are padded to a device-count
    multiple (padded rows carry −inf/False sentinels and are sliced off).
    Like the JAX package's mesh, it keeps no sharded residency: each step
    gathers its rows from the store's host-resident arrays and places them
    on the shards."""

    name = "mesh"

    def __init__(self, store, mesh=None):
        self.store = store
        self.cfg = store.cfg
        kind = _device_of(store).type
        if mesh is None:
            devices = local_devices(kind)
            mesh = make_mesh((len(devices),), ("data",), devices)
        if kind == "cuda" and any(d.type != "cuda" for d in mesh.devices):
            raise ValueError(f"a store on the card runs on a mesh of CUDA "
                             f"devices, not {mesh}")
        self.mesh = mesh
        self.n_dev = mesh.size
        self._masks = store.resident_masks()
        self._tables_np = store.chi_host()
        self._epoch = getattr(store, "epoch", 0)
        self._rb = np.asarray(self.cfg.row_bounds, np.int32)
        self._cb = np.asarray(self.cfg.col_bounds, np.int32)
        self._bounds_step = make_chi_bounds_step(mesh)
        self._packed = is_packed(store)
        # Packed steps share the float steps' call signatures and shardings
        # (words axis for pixel-column axis), so every call site below is
        # representation-agnostic once the right step is pinned here.
        if self._packed:
            self._verify_step = make_verify_packed_step(mesh)
            self._agg_step = make_mask_agg_packed_step(mesh)
            self._multi_step = make_cp_multi_packed_step(mesh)
            self._pair_step = make_pair_counts_packed_step(mesh)
            self._fused_verify_step = make_fused_verify_step(mesh)
        else:
            self._verify_step = make_verify_step(mesh)
            self._agg_step = make_mask_agg_step(mesh)
            self._multi_step = make_cp_multi_step(mesh)
            self._pair_step = make_pair_counts_step(mesh)
            self._fused_verify_step = None
        self._select_steps: dict = {}
        self._pair_cells_steps: dict = {}   # pair stat → sharded cells step
        self._tier_bnds: dict = {}          # tier grid → (row_b, col_b)

    def sync(self):
        """Re-pin the host-resident mask/CHI arrays after a store mutation.
        The store maintains ``resident_masks`` incrementally, so memory-tier
        refreshes are a view swap; shards are re-padded lazily per step
        (the mesh has no persistent sharded residency to patch)."""
        if self._epoch == getattr(self.store, "epoch", 0):
            return
        self._masks = self.store.resident_masks()
        self._tables_np = self.store.chi_host()
        self._epoch = self.store.epoch
        _BACKEND_SYNCS.labels(backend=self.name).inc()

    def _pad(self, arr, fill=0):
        """Pad the leading dim to a positive device-count multiple."""
        n = len(arr)
        r = (-n) % self.n_dev if n else self.n_dev
        if r == 0:
            return arr, n
        pad = np.full((r,) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad]), n

    def bounds(self, ctx, expr):
        if hasattr(ctx, "pair_rois"):
            return ctx.bounds(expr, pair_leaf=self._pair_cells)
        return ctx.bounds(expr, cp_leaf=self._cp_bounds)

    def _tier_bounds(self, g: int):
        pair = self._tier_bnds.get(g)
        if pair is None:
            tcfg = self.cfg.for_grid(g)
            pair = (np.asarray(tcfg.row_bounds, np.int32),
                    np.asarray(tcfg.col_bounds, np.int32))
            self._tier_bnds[g] = pair
        return pair

    def _cp_bounds(self, mctx, node):
        pos = np.asarray(mctx.positions)
        rois = mctx.resolve_rois(node.roi, pos).astype(np.int32)
        g = getattr(mctx, "tier", None)
        if g is None or g == self.cfg.grid:
            cfg, tables, rb, cb = self.cfg, self._tables_np, self._rb, self._cb
        else:
            # coarse ladder rung: the store's host tier cache (maintained
            # incrementally across mutations) + the tier's grid boundaries
            cfg = self.cfg.for_grid(g)
            tables = self.store.chi_tier_host(g)
            rb, cb = self._tier_bounds(g)
        tab_p, n = self._pad(tables[pos])
        rois_p, _ = self._pad(rois)
        lb, ub = self._bounds_step(tab_p, rois_p, rb, cb,
                                   value_ks(cfg, node.lv, node.uv))
        return (_host(lb)[:n].astype(np.float64),
                _host(ub)[:n].astype(np.float64))

    def _pair_cells(self, pctx, node):
        step = self._pair_cells_steps.get(node.stat)
        if step is None:
            step = make_pair_cells_step(self.mesh, node.stat)
            self._pair_cells_steps[node.stat] = step
        pos_a = np.asarray(pctx.pos_a)
        pos_b = np.asarray(pctx.pos_b)
        rois = np.asarray(pctx.pair_rois(node.roi), np.int32)
        tab_a_p, n = self._pad(self._tables_np[pos_a])
        tab_b_p, _ = self._pad(self._tables_np[pos_b])
        rois_p, _ = self._pad(rois)
        ka = _threshold_ks(self.cfg, node.ta)
        kb = _threshold_ks(self.cfg, node.tb)
        ks = np.array([ka[0], ka[1], kb[0], kb[1]], np.int32)
        lb, ub = step(tab_a_p, tab_b_p, rois_p, ks, self._rb, self._cb)
        return (_host(lb)[:n].astype(np.float64),
                _host(ub)[:n].astype(np.float64))

    def verify_counts(self, ctx, batch, terms):
        terms = list(terms)
        pos = ctx.positions[batch]
        masks_p, n = self._pad(self._masks[pos])
        if len(terms) == 1:
            # single descriptor → the plain sharded verify step
            t = terms[0]
            rois_p, _ = self._pad(
                ctx.resolve_rois(t.roi, pos).astype(np.int32))
            counts = self._verify_step(masks_p, rois_p, np.float32(t.lv),
                                       np.float32(min(t.uv, F32_MAX)))
            return {t: _host(counts)[:n].astype(np.float64)}
        # several distinct terms (predicate + ranking) → one fused pass
        # over the sharded batch, exactly like the scheduler's route
        rois_q, lvs, uvs = spec_arrays(
            [(self._pad(ctx.resolve_rois(t.roi, pos).astype(np.int32))[0],
              t.lv, t.uv) for t in terms])
        counts = _host(self._multi_step(masks_p, rois_q, lvs, uvs))
        return {t: counts[i, :n].astype(np.float64)
                for i, t in enumerate(terms)}

    def _fused_verify_batch(self, ctx, batch, pos, rois_q, lvs, uvs,
                            decided, lb):
        masks_p, n = self._pad(self._masks[pos])
        pad = len(masks_p) - n
        if pad:
            # padded rows: empty ROI (zero area) + undecided → count 0
            rois_q = np.pad(rois_q, ((0, 0), (0, pad), (0, 0)))
            decided = np.pad(decided, ((0, 0), (0, pad)))
            lb = np.pad(lb, ((0, 0), (0, pad)))
        counts = self._fused_verify_step(masks_p, rois_q, lvs, uvs,
                                         decided, lb)
        return _host(counts)[:, :n]

    def topk_candidates(self, lb, ub, k, desc, definite, possible):
        if k <= 0 or int(np.count_nonzero(definite)) < k:
            return possible.copy()
        pes32 = (lb if desc else -ub).astype(np.float32)
        pes_p, n = self._pad(pes32, fill=np.float32(-np.inf))
        def_p, _ = self._pad(np.asarray(definite, bool), fill=False)
        step = self._select_steps.get(k)
        if step is None:
            step = self._select_steps[k] = make_topk_select_step(self.mesh, k)
        ids = np.arange(len(pes_p), dtype=np.int32)
        tau_idx = int(step(pes_p, def_p, ids))
        return self._alive_from_index(lb, ub, k, desc, definite, possible,
                                      pes32, tau_idx)

    def mask_agg_counts(self, gctx, node, gidx):
        gidx = np.asarray(gidx)
        s = gctx.groups.shape[1]
        grp = self._masks[gctx.groups[gidx].reshape(-1)]
        # row shape is (H, W) float or (H, words) packed
        grp = grp.reshape((len(gidx), s) + self._masks.shape[1:])
        rois = gctx.resolve_group_rois(node.roi, gidx).astype(np.int32)
        grp_p, n = self._pad(grp)
        rois_p, _ = self._pad(rois)
        tdt = np.float32 if self._packed else grp.dtype
        inter, union = self._agg_step(grp_p, rois_p,
                                      np.asarray(node.thresh, tdt))
        counts = inter if node.agg == "intersect" else union
        return _host(counts)[:n].astype(np.float64)

    def fused_counts(self, store, positions, specs):
        masks_p, n = self._pad(self._masks[np.asarray(positions)])
        rois_q, lvs, uvs = spec_arrays(
            [(self._pad(np.asarray(sp[0], np.int32))[0], sp[1], sp[2])
             for sp in specs])
        counts = self._multi_step(masks_p, rois_q, lvs, uvs)
        return _host(counts)[:, :n]

    def fused_pair_counts(self, store, pos_a, pos_b, specs):
        # Pair rows shard together: the i-th pair's A and B tiles land on
        # the same device, so the fused kernel needs no collective.
        a_p, n = self._pad(self._masks[np.asarray(pos_a)])
        b_p, _ = self._pad(self._masks[np.asarray(pos_b)])
        out = np.empty((len(specs), 3, n), np.int64)
        for qi, (rois, ta, tb) in enumerate(specs):
            rois_p, _ = self._pad(np.asarray(rois, np.int32))
            trio = self._pair_step(a_p, b_p, rois_p, np.float32(ta),
                                   np.float32(tb))
            for row, counts in enumerate(trio):
                out[qi, row] = _host(counts)[:n]
        return out


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

_HOST = HostBackend()
_NAMED = {"device": DeviceBackend, "mesh": MeshBackend}


def host_backend() -> HostBackend:
    """The stateless host backend singleton (the default on a CPU store)."""
    return _HOST


def get_backend(store, backend=None) -> ExecBackend:
    """Resolve a backend spec against a store.

    ``backend`` is ``None`` (the store's own device decides: the device
    backend on a CUDA store, the host backend otherwise; the mesh is only
    ever named), ``"host"``, a backend *name* (``"device"``/``"mesh"`` —
    instances are cached per store, so the resident mask/CHI upload happens
    once), or an :class:`ExecBackend` instance (e.g. a :class:`MeshBackend`
    built over an explicit mesh).
    """
    if backend is None:
        backend = "device" if _device_of(store).type == "cuda" else "host"
    if backend == "host":
        _BACKEND_RESOLUTIONS.labels(backend="host").inc()
        return _HOST
    if isinstance(backend, ExecBackend):
        backend.sync()
        _BACKEND_RESOLUTIONS.labels(backend=backend.name).inc()
        return backend
    cls = _NAMED.get(backend)
    if cls is None:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{['host'] + sorted(_NAMED)} or an ExecBackend")
    cache = store.backend_cache
    if backend not in cache:
        cache[backend] = cls(store)
        _BACKEND_BUILDS.labels(backend=backend).inc()
    else:
        cache[backend].sync()
    _BACKEND_RESOLUTIONS.labels(backend=backend).inc()
    return cache[backend]


__all__ = ["ExecBackend", "HostBackend", "DeviceBackend", "MeshBackend",
           "F32_MAX", "chi_verdicts", "get_backend", "host_backend",
           "is_packed", "spec_arrays"]
