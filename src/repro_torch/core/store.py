"""MaskStore — the tiered, epoch-versioned mask database behind
``MasksDatabaseView``.

The paper's schema::

    MasksDatabaseView(mask_id, image_id, model_id, mask_type, mask REAL[][])

Metadata + the CHI table are small and always memory/HBM-resident; mask
*bytes* live in a configurable tier:

* ``disk``   — one ``.npy`` file per mask (the paper's file-per-mask layout on
               EBS; this is the tier whose I/O the index avoids).  All reads
               are metered: real wall time + a modeled EBS-gp3 time
               (125 MB/s throughput, 3000 IOPS) so benchmarks can report the
               paper's own I/O model independent of the container's page
               cache.
* ``memory`` — a host ndarray (the "hot" tier; also what a GPU host RAM tier
               looks like).
* ``device`` — a torch tensor on the store's device (HBM-resident on the
               card; what the device backend verifies against).

The engine only sees :meth:`load` / :meth:`load_all`, so tiers are
interchangeable.

Mutability (the full paper's in-place index maintenance, DESIGN.md §8):
the store is a *database*, not a frozen snapshot.  :meth:`append`,
:meth:`update` and :meth:`delete` mutate it under a monotonically
increasing :attr:`epoch`.  CHI maintenance is incremental — the index is a
**chunked** list of prefix-sum tables, one chunk per ingest batch, so an
append builds tables only for the delta and never re-copies the existing
``(B, G+1, G+1, NB+1)`` tensor.  Readers pin an epoch through
:meth:`snapshot`; memory-resident tiers serve pinned readers forever
(mutations are copy-on-write at the array level), the disk tier serves
them until one of *their* mask_ids is overwritten, after which resuming
raises :class:`StaleRunError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Sequence

import numpy as np
import torch

from . import packing
from .chi import CHIConfig, build_chi_delta, build_chi_np, tier_slice

# Paper's EBS gp3 provisioning (§4): 125 MiB/s, 3000 IOPS.
EBS_THROUGHPUT_BYTES_S = 125 * 1024 * 1024
EBS_IOPS = 3000.0
EBS_IO_CHUNK = 256 * 1024  # gp3 accounting chunk for large sequential reads

# Shared-load cache default bound (satellite: the cache must not grow
# without limit across a long-lived service).
DEFAULT_CACHE_BYTES = 256 * 1024 * 1024

# Compact the chunked CHI once appends fragment it this far — keeps the
# cross-chunk gather and the full-table concat O(few chunks).
_CHI_MAX_CHUNKS = 64

# Mutations older than this fall off the dirty log; snapshot readers pinned
# before the log's floor are conservatively treated as stale (disk tier).
_DIRTY_LOG_MAX = 256


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array — always a copy, never a view, so the
    in-place device updates below cannot write through into host buffers
    (``torch.from_numpy`` alone would alias them on a CPU device).  Packed
    ``uint32`` words land as their ``int32`` bit view
    (:func:`packing.torch_bits`)."""
    return torch.from_numpy(packing.torch_bits(arr)).to(device, copy=True)


def _index(positions, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(positions, np.int64)).to(device)


class StaleRunError(RuntimeError):
    """A reader pinned to an earlier store epoch needs data the store can
    no longer serve consistently (its bytes were overwritten, or its
    backend's device residency was refreshed past the pinned epoch)."""


@dataclasses.dataclass
class IOStats:
    """Disk-tier accounting — the quantity MaskSearch's index minimizes."""

    files_read: int = 0
    bytes_read: int = 0
    wall_time_s: float = 0.0

    @property
    def modeled_ebs_time_s(self) -> float:
        """Time under the paper's EBS model: throughput-bound transfer plus
        per-request IOPS cost (each file ≥1 I/O, 256 KiB accounting chunks)."""
        ios = self.files_read + self.bytes_read // EBS_IO_CHUNK
        return self.bytes_read / EBS_THROUGHPUT_BYTES_S + ios / EBS_IOPS

    # Reflection, not field lists: a counter added to the dataclass can
    # never silently drift out of merge/reset (tests/test_stats_consistency
    # asserts this for every stats dataclass).
    def merge(self, other: "IOStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other,
                                                                  f.name))

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["modeled_ebs_time_s"] = self.modeled_ebs_time_s
        return d

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


@dataclasses.dataclass
class CacheStats:
    """Shared-load cache accounting (cross-query / cross-session sharing).

    ``bytes_saved`` is the disk I/O that cache hits avoided — the quantity
    the service's fused verification maximizes across in-flight sessions.
    ``evictions`` counts rows displaced by the capacity bound;
    ``invalidations`` counts rows dropped because :meth:`MaskStore.update`
    rewrote their bytes (epoch maintenance, not capacity pressure)."""

    hits: int = 0
    misses: int = 0
    bytes_saved: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


MASK_META_DTYPE = np.dtype([
    ("mask_id", np.int64),
    ("image_id", np.int64),
    ("model_id", np.int32),
    ("mask_type", np.int32),
])


def _positions_of(meta: np.ndarray, mask_ids) -> np.ndarray:
    """Row positions for the given mask_ids against a meta array."""
    ids = np.atleast_1d(np.asarray(mask_ids, dtype=np.int64))
    order = np.argsort(meta["mask_id"], kind="stable")
    sorted_ids = meta["mask_id"][order]
    pos = np.clip(np.searchsorted(sorted_ids, ids), 0,
                  max(len(sorted_ids) - 1, 0))
    if len(sorted_ids) == 0 or np.any(sorted_ids[pos] != ids):
        raise KeyError("unknown mask_id in lookup")
    return order[pos]


def _select(meta: np.ndarray, conds: dict) -> np.ndarray:
    keep = np.ones(len(meta), dtype=bool)
    for col, val in conds.items():
        vals = np.atleast_1d(np.asarray(val))
        keep &= np.isin(meta[col], vals)
    return np.nonzero(keep)[0]


def _load_row_spans(cfg: CHIConfig, io: IOStats, meta: np.ndarray, masks,
                    path_of, positions: np.ndarray, spans: np.ndarray,
                    row_width: int | None = None, dtype=np.float32):
    """Shared partial-row load loop (live store + epoch-pinned snapshot):
    read only each mask's ROI row span — from the resident array when one
    exists, else by npy memmap slice — metering rows read plus a 4 KiB
    header/page floor per file under the EBS model's granularity.

    ``row_width``/``dtype`` describe the stored representation of one mask
    row (``cfg.width`` float32 on the float tier, ``words_for(width)``
    uint32 on the packed tier) so metered bytes match what the tier
    actually moves."""
    positions = np.asarray(positions, dtype=np.int64)
    spans = np.asarray(spans, dtype=np.int64)
    heights = np.maximum(spans[:, 1] - spans[:, 0], 0)
    max_span = max(int(heights.max()) if len(heights) else 0, 1)
    if row_width is None:
        row_width = cfg.width
    buf = np.zeros((len(positions), max_span, row_width), dtype)
    t0 = time.perf_counter()
    nbytes = 0
    for i, p in enumerate(positions):
        r0, r1 = int(spans[i, 0]), int(spans[i, 1])
        if r1 <= r0:
            continue
        if masks is not None:
            rows = np.asarray(masks)[p, r0:r1]
        else:
            mm = np.load(path_of(meta["mask_id"][p]), mmap_mode="r")
            rows = np.asarray(mm[r0:r1])
        buf[i, : r1 - r0] = rows
        nbytes += rows.nbytes + 4096     # + header/page floor
    io.wall_time_s += time.perf_counter() - t0
    io.files_read += len(positions)
    io.bytes_read += nbytes
    return buf, heights.astype(np.int32)


class MaskStore:
    """A partition of the mask database (one shard in the distributed case)."""

    def __init__(self, cfg: CHIConfig, meta: np.ndarray, *, tier: str,
                 root: str | None = None, masks: np.ndarray | None = None,
                 chi_table: np.ndarray | None = None,
                 chi_chunks: list | None = None, epoch: int = 0,
                 packed: bool = False, device="cuda"):
        if meta.dtype != MASK_META_DTYPE:
            raise ValueError("meta must use MASK_META_DTYPE")
        self.cfg = cfg
        # Where the device-resident tier, the device CHI caches and every
        # kernel launch for this store live (tests pass "cpu").
        self.device = torch.device(device)
        self.meta = meta
        self.tier = tier
        self.root = root
        # Bitpacked binary tier (DESIGN.md §12): mask rows live as
        # little-endian uint32 words, 1 bit/pixel.  `masks` (and every
        # load/resident surface) then carries (…, H, words) uint32; the
        # device copy holds the same bits as int32 (packing.torch_bits).
        self.packed = bool(packed)
        self.words = packing.words_for(cfg.width)
        self._masks = masks
        # Spare-capacity buffer behind self._masks (memory tier): appends
        # write into the tail so existing epoch views never move.
        self._masks_buf = masks
        self.io = IOStats()
        # Epoch versioning: every mutation bumps `epoch`; the dirty log
        # records which mask_ids each bump touched so disk-tier snapshot
        # readers can tell whether *their* bytes moved.
        self.epoch = int(epoch)
        self._dirty_log: list[tuple[int, np.ndarray | None]] = []
        self._dirty_floor = int(epoch)
        # Resident copies + per-store execution backends (core/backend.py):
        # device/mesh backends pin mask bytes once and refresh per epoch.
        self._resident: np.ndarray | None = None
        self._device_masks = None
        self._backend_cache: dict = {}
        # Cross-query shared-load cache (bounded; see enable_cache).
        self._cache_map: np.ndarray | None = None
        self._cache_arr: np.ndarray | None = None
        self._cache_pos: np.ndarray | None = None
        self._cache_used = 0
        self._cache_clock = 0
        self._cache_cap = 0
        self.cache_stats = CacheStats()
        # CHI: a chunked list of host prefix-sum tables (one chunk per
        # ingest batch) + lazily materialized host-concat / device caches.
        if chi_table is not None and chi_chunks is not None:
            raise ValueError("pass chi_table or chi_chunks, not both")
        if chi_chunks is not None:
            self._chi_chunks = [np.asarray(c, np.int32) for c in chi_chunks]
        elif chi_table is not None:
            self._chi_chunks = [np.asarray(chi_table, np.int32)]
        elif masks is not None:
            if self.packed:
                # CHI is built from pixel values; packed constructors
                # (create_memory/create_disk) index the float input before
                # packing and pass the table in.
                raise ValueError("packed stores need a prebuilt CHI table")
            self._chi_chunks = [build_chi_np(np.asarray(masks), cfg)]
        else:
            self._chi_chunks = None
        self._chi_cat: np.ndarray | None = None     # host full-table cache
        self._chi_dev = None                        # device full-table cache
        # Pyramid tiers (DESIGN.md §13): coarse tables are exact strided
        # subsamples of the finest chunks, materialized lazily per tier and
        # then maintained incrementally across mutations — never persisted
        # (disk round-trips re-derive them from the chunked layout).
        self._chi_tier_host: dict[int, np.ndarray] = {}
        self._chi_tier_dev: dict = {}
        self._chi_stats: np.ndarray | None = None   # corner value CDF cache
        self._chunk_files: list[str] | None = None  # disk tier persistence

    # -- construction ------------------------------------------------------

    @classmethod
    def create_memory(cls, masks: np.ndarray, meta: np.ndarray, cfg: CHIConfig,
                      chi_table: np.ndarray | None = None,
                      packed: bool = False, device="cuda") -> "MaskStore":
        """``packed=True`` declares the mask type binary at ingest: values
        are validated to be exactly {0, 1}, indexed from the float input,
        then stored 1 bit/pixel (DESIGN.md §12)."""
        masks = np.asarray(masks)
        if packed:
            packing.validate_binary(masks)
            if chi_table is None:
                chi_table = build_chi_np(np.asarray(masks, np.float32), cfg)
            masks = packing.pack_masks(masks)
        return cls(cfg, meta, tier="memory", masks=masks,
                   chi_table=chi_table, packed=packed, device=device)

    @classmethod
    def from_reference_state(cls, state: dict, device="cuda") -> "MaskStore":
        """A memory-tier store built from another implementation's plain
        state — e.g. the JAX package's ``MaskStore`` — so both run on
        identical data.  ``state`` holds numpy arrays and plain values:
        ``masks`` (``resident_masks()``), ``meta``, ``chi`` (``chi_host()``),
        ``chunk_lens`` (rows per CHI chunk, in order), ``epoch``, ``cfg``
        (the CHIConfig fields as a dict) and ``packed`` (then ``masks``
        holds the uint32 words)."""
        packed = bool(state.get("packed", False))
        raw = dict(state["cfg"])
        if raw.get("thresholds") is not None:
            raw["thresholds"] = tuple(raw["thresholds"])
        chi = np.asarray(state["chi"], np.int32)
        lens = list(state.get("chunk_lens") or [len(chi)])
        if sum(lens) != len(chi):
            raise ValueError("chunk_lens must sum to the CHI row count")
        chunks = np.split(chi, np.cumsum(lens)[:-1])
        return cls(CHIConfig(**raw),
                   np.array(state["meta"], dtype=MASK_META_DTYPE),
                   tier="memory",
                   masks=np.array(state["masks"],
                                  np.uint32 if packed else np.float32),
                   chi_chunks=chunks, epoch=int(state.get("epoch", 0)),
                   packed=packed, device=device)

    @classmethod
    def create_disk(cls, root: str, masks: np.ndarray, meta: np.ndarray,
                    cfg: CHIConfig, chi_table: np.ndarray | None = None,
                    packed: bool = False, device="cuda") -> "MaskStore":
        """Ingest: write one .npy per mask + persist CHI and metadata.
        With ``packed=True`` the per-mask files hold uint32 words (the CHI
        is still built from the float input before packing)."""
        os.makedirs(os.path.join(root, "masks"), exist_ok=True)
        masks = np.asarray(masks, dtype=np.float32)
        if chi_table is None:
            chi_table = build_chi_np(masks, cfg)
        if packed:
            packing.validate_binary(masks)
            masks = packing.pack_masks(masks)
        for row, m in zip(meta, masks):
            np.save(os.path.join(root, "masks", f"{int(row['mask_id'])}.npy"), m)
        np.save(os.path.join(root, "chi.npy"), np.asarray(chi_table))
        np.save(os.path.join(root, "meta.npy"), meta)
        store = cls(cfg, meta, tier="disk", root=root, chi_table=chi_table,
                    packed=packed, device=device)
        store._chunk_files = ["chi.npy"]
        store._write_config()
        return store

    @classmethod
    def open_disk(cls, root: str, device="cuda") -> "MaskStore":
        with open(os.path.join(root, "config.json")) as f:
            raw = json.load(f)
        cfg = CHIConfig(grid=raw["grid"], num_bins=raw["num_bins"],
                        height=raw["height"], width=raw["width"],
                        thresholds=None if raw["thresholds"] is None
                        else tuple(raw["thresholds"]))
        meta = np.load(os.path.join(root, "meta.npy"))
        chunk_files = raw.get("chi_chunks", ["chi.npy"])
        chunks = [np.load(os.path.join(root, f)) for f in chunk_files]
        store = cls(cfg, meta, tier="disk", root=root, chi_chunks=chunks,
                    epoch=raw.get("epoch", 0),
                    packed=raw.get("packed", False), device=device)
        store._chunk_files = list(chunk_files)
        return store

    def _write_config(self) -> None:
        cfg = self.cfg
        with open(os.path.join(self.root, "config.json"), "w") as f:
            json.dump({
                "grid": cfg.grid, "num_bins": cfg.num_bins,
                "height": cfg.height, "width": cfg.width,
                "thresholds": None if cfg.thresholds is None
                else list(cfg.thresholds),
                "epoch": self.epoch,
                "chi_chunks": self._chunk_files,
                "packed": self.packed,
            }, f)

    def _mask_path(self, mask_id: int) -> str:
        return os.path.join(self.root, "masks", f"{int(mask_id)}.npy")

    # -- properties ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.meta)

    @property
    def row_shape(self) -> tuple:
        """Stored shape of one mask: (H, W) float or (H, words) packed."""
        if self.packed:
            return (self.cfg.height, self.words)
        return (self.cfg.height, self.cfg.width)

    @property
    def row_dtype(self):
        return np.uint32 if self.packed else np.float32

    @property
    def row_nbytes(self) -> int:
        """Bytes one stored mask actually occupies — what the shared-load
        cache budget and ``bytes_saved`` accounting are denominated in."""
        h, w = self.row_shape
        return h * w * np.dtype(self.row_dtype).itemsize

    @property
    def chi_table(self):
        """The full CHI table as one int32 tensor on the store's device
        (cached; maintained incrementally across mutations once
        materialized)."""
        if self._chi_chunks is None:
            raise ValueError("store has no CHI table; ingest with an index")
        if self._chi_dev is None:
            self._chi_dev = _to_device(self.chi_host(), self.device)
        return self._chi_dev

    def chi_host(self, positions: np.ndarray | None = None) -> np.ndarray:
        """CHI rows as host numpy — the whole table (cached concat of the
        chunks) or a gather of specific row positions across chunks."""
        if self._chi_chunks is None:
            raise ValueError("store has no CHI table; ingest with an index")
        if positions is None:
            if self._chi_cat is None:
                self._chi_cat = (self._chi_chunks[0]
                                 if len(self._chi_chunks) == 1
                                 else np.concatenate(self._chi_chunks))
            return self._chi_cat
        positions = np.asarray(positions, dtype=np.int64)
        starts, cid = self._chunk_of(positions)
        out = np.empty((len(positions),) + self._chi_chunks[0].shape[1:],
                       np.int32)
        for c in np.unique(cid):
            sel = cid == c
            out[sel] = self._chi_chunks[c][positions[sel] - starts[c]]
        return out

    def _chunk_of(self, positions: np.ndarray):
        """Map row positions to their owning CHI chunk: returns
        ``(chunk_starts, chunk_index_per_position)``."""
        lens = np.array([len(c) for c in self._chi_chunks], dtype=np.int64)
        ends = np.cumsum(lens)
        return ends - lens, np.searchsorted(ends, positions, side="right")

    @property
    def chi_chunks(self) -> list | None:
        """The chunked CHI layout (read-only view for tests/benchmarks)."""
        return self._chi_chunks

    # -- pyramid tiers (DESIGN.md §13) ---------------------------------------

    def chi_tier_host(self, g: int) -> np.ndarray:
        """The tier-``g`` CHI table as host numpy — the finest tier is
        :meth:`chi_host` itself; coarser tiers are exact strided subsamples,
        materialized once and maintained incrementally across mutations."""
        if g == self.cfg.grid:
            return self.chi_host()
        tab = self._chi_tier_host.get(g)
        if tab is None:
            tab = tier_slice(self.chi_host(), self.cfg.grid, g)
            self._chi_tier_host[g] = tab
        return tab

    def chi_tier_table(self, g: int):
        """:meth:`chi_tier_host` pinned in device memory (cached per tier)."""
        if g == self.cfg.grid:
            return self.chi_table
        tab = self._chi_tier_dev.get(g)
        if tab is None:
            tab = _to_device(self.chi_tier_host(g), self.device)
            self._chi_tier_dev[g] = tab
        return tab

    def chi_value_stats(self) -> np.ndarray:
        """(B, NB+1) whole-image value CDF per mask — the CHI's own corner
        plane ``table[:, -1, -1, :]`` (``stats[b, k]`` counts pixels with
        value < ``edges[k]``; the last entry is H·W).  This is the build-time
        index statistic the cost-based optimizer estimates selectivities
        from — no extra state, kept fresh incrementally like the tiers."""
        if self._chi_stats is None:
            self._chi_stats = np.ascontiguousarray(
                self.chi_host()[:, -1, -1, :])
        return self._chi_stats

    @property
    def mask_ids(self) -> np.ndarray:
        return self.meta["mask_id"]

    @property
    def cache_enabled(self) -> bool:
        """Whether the cross-query load cache is on — the public signal
        for planners choosing between cached whole-row loads and
        partial-row reads (see :meth:`enable_cache`)."""
        return self._cache_map is not None

    @property
    def backend_cache(self) -> dict:
        """Named :class:`ExecBackend` instances resident over this store
        (owned by ``core.backend.get_backend``, keyed by backend name)."""
        return self._backend_cache

    def positions_of(self, mask_ids: Sequence[int]) -> np.ndarray:
        """Row positions for the given mask_ids (metadata is host-side)."""
        return _positions_of(self.meta, mask_ids)

    def select(self, **conds) -> np.ndarray:
        """Row positions matching metadata equality/IN predicates, e.g.
        ``select(mask_type=(1, 2), image_id=7)`` — the relational WHERE over
        everything except the mask column."""
        return _select(self.meta, conds)

    # -- mutation (the epoch-versioned write path) ---------------------------

    def _bump(self, changed_ids: np.ndarray | None) -> int:
        """Advance the epoch, recording which mask_ids the mutation rewrote
        (None for pure appends — they dirty nothing a pinned reader owns)."""
        self.epoch += 1
        self._dirty_log.append(
            (self.epoch,
             None if changed_ids is None
             else np.asarray(changed_ids, np.int64)))
        if len(self._dirty_log) > _DIRTY_LOG_MAX:
            drop = len(self._dirty_log) - _DIRTY_LOG_MAX
            self._dirty_floor = self._dirty_log[drop - 1][0]
            del self._dirty_log[:drop]
        return self.epoch

    def ids_dirty_since(self, epoch: int, mask_ids: np.ndarray) -> bool:
        """Whether any of ``mask_ids`` was updated/deleted after ``epoch``
        (conservatively True when the dirty log no longer reaches back)."""
        if epoch >= self.epoch:
            return False
        if epoch < self._dirty_floor:
            return True
        ids = np.asarray(mask_ids, np.int64)
        for ep, changed in self._dirty_log:
            if ep <= epoch or changed is None:
                continue
            if np.isin(ids, changed).any():
                return True
        return False

    def snapshot(self) -> "StoreSnapshot":
        """A read-only view pinned at the current epoch (see module docs)."""
        return StoreSnapshot(self)

    def _check_mutable(self) -> None:
        if self.tier not in ("memory", "disk"):
            raise ValueError(f"tier {self.tier!r} does not support mutation")
        if self._chi_chunks is None:
            raise ValueError("store has no CHI index; cannot maintain it "
                             "incrementally")

    def _cow_masks_buf(self, rows: np.ndarray) -> np.ndarray:
        """Copy-on-write replacement buffer for the memory tier: a fresh
        allocation (pinned readers keep the old arrays) that retains the
        old buffer's spare capacity, so appends after an update/delete
        stay amortized O(delta)."""
        cap = max(len(self._masks_buf) if self._masks_buf is not None else 0,
                  len(rows))
        buf = np.empty((cap,) + rows.shape[1:], rows.dtype)
        buf[:len(rows)] = rows
        return buf

    def _append_memory_rows(self, masks: np.ndarray) -> None:
        """Write new rows into the spare capacity behind ``self._masks`` —
        existing epoch views keep aliasing the old prefix untouched."""
        n = len(self._masks)
        need = n + len(masks)
        buf = self._masks_buf
        if buf is None or need > len(buf):
            cap = max(need, 2 * n, 8)
            grown = np.empty((cap,) + self._masks.shape[1:],
                             self._masks.dtype)
            grown[:n] = self._masks
            buf = grown
        buf[n:need] = masks.astype(self._masks.dtype, copy=False)
        self._masks_buf = buf
        self._masks = buf[:need]

    def append(self, masks: np.ndarray, meta: np.ndarray) -> int:
        """Append new masks (+ metadata rows) and index them incrementally:
        CHI tables are built **only for the delta** and attached as a new
        chunk — O(len(masks)), never O(len(store)).  Returns the new epoch."""
        self._check_mutable()
        meta = np.asarray(meta)
        if meta.dtype != MASK_META_DTYPE:
            raise ValueError("meta must use MASK_META_DTYPE")
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 2:
            masks = masks[None]
        if masks.shape[1:] != (self.cfg.height, self.cfg.width):
            raise ValueError(f"mask shape {masks.shape[1:]} != cfg "
                             f"{(self.cfg.height, self.cfg.width)}")
        if len(masks) != len(meta):
            raise ValueError("masks and meta length mismatch")
        if len(masks) == 0:
            return self.epoch
        new_ids = meta["mask_id"]
        if len(np.unique(new_ids)) != len(new_ids) or \
                np.isin(new_ids, self.meta["mask_id"]).any():
            raise ValueError("append mask_ids must be unique and not "
                             "already present (use update to replace)")
        if self.packed:
            packing.validate_binary(masks)
        chunk = build_chi_delta(masks, self.cfg, self.device)  # from pixels
        stored = packing.pack_masks(masks) if self.packed else masks
        # mask bytes
        if self.tier == "memory":
            self._append_memory_rows(stored)
        else:
            for row, m in zip(meta, stored):
                np.save(self._mask_path(row["mask_id"]), m)
        # resident / device mirrors: extend incrementally when materialized
        if self._resident is not None:
            if self.tier == "memory":
                self._resident = None        # re-derived as a cheap view
            else:
                self._resident = np.concatenate([self._resident, stored])
        if self._device_masks is not None:
            self._device_masks = torch.cat(
                [self._device_masks, _to_device(stored, self.device)])
        # CHI: new chunk; no existing rows are copied
        self._chi_chunks.append(chunk)
        if self._chi_dev is not None:
            self._chi_dev = torch.cat(
                [self._chi_dev, _to_device(chunk, self.device)])
        self._chi_cat = None
        # pyramid tiers / value stats: extend materialized caches with the
        # delta's slice — same O(delta) contract as the chunk itself
        for g, tab in list(self._chi_tier_host.items()):
            self._chi_tier_host[g] = np.concatenate(
                [tab, tier_slice(chunk, self.cfg.grid, g)])
        for g, tab in list(self._chi_tier_dev.items()):
            self._chi_tier_dev[g] = torch.cat(
                [tab, _to_device(tier_slice(chunk, self.cfg.grid, g),
                                 self.device)])
        if self._chi_stats is not None:
            self._chi_stats = np.concatenate(
                [self._chi_stats, np.ascontiguousarray(chunk[:, -1, -1, :])])
        # metadata + shared-load cache extension
        self.meta = np.concatenate([self.meta, meta])
        if self._cache_map is not None:
            self._cache_map = np.concatenate(
                [self._cache_map, np.full(len(meta), -1, np.int64)])
        self._bump(None)
        if self.tier == "disk":
            np.save(os.path.join(self.root, "meta.npy"), self.meta)
            fname = f"chi.{len(self._chunk_files)}.npy"
            np.save(os.path.join(self.root, fname), chunk)
            self._chunk_files.append(fname)
            self._write_config()
        if len(self._chi_chunks) > _CHI_MAX_CHUNKS:
            self.compact_chi()
        return self.epoch

    def update(self, mask_ids: Sequence[int], masks: np.ndarray,
               meta: np.ndarray | None = None) -> int:
        """Replace mask bytes for existing ids, rebuilding CHI rows only for
        the delta (patched into their owning chunks).  ``meta`` optionally
        replaces the metadata rows too (mask_ids must match).  Returns the
        new epoch.  Arrays visible to pinned readers are never written in
        place — memory-tier mask and meta updates are copy-on-write."""
        self._check_mutable()
        mask_ids = np.atleast_1d(np.asarray(mask_ids, np.int64))
        if len(np.unique(mask_ids)) != len(mask_ids):
            raise ValueError("update mask_ids must be unique")
        positions = self.positions_of(mask_ids)
        if meta is not None:
            meta = np.asarray(meta)
            if meta.dtype != MASK_META_DTYPE:
                raise ValueError("meta must use MASK_META_DTYPE")
            if len(meta) != len(mask_ids) or \
                    np.any(meta["mask_id"] != mask_ids):
                raise ValueError("update meta rows must match mask_ids")
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 2:
            masks = masks[None]
        if masks.shape != (len(positions), self.cfg.height, self.cfg.width):
            raise ValueError(f"expected masks of shape "
                             f"{(len(positions), self.cfg.height, self.cfg.width)}, "
                             f"got {masks.shape}")
        if len(positions) == 0:
            return self.epoch
        if self.packed:
            packing.validate_binary(masks)
        new_rows = build_chi_delta(masks, self.cfg, self.device)
        stored = packing.pack_masks(masks) if self.packed else masks
        # patch CHI rows inside their owning chunks (copy-on-write per chunk)
        starts, cid = self._chunk_of(positions)
        touched_chunks = np.unique(cid)
        for c in touched_chunks:
            sel = cid == c
            patched = self._chi_chunks[c].copy()
            patched[positions[sel] - starts[c]] = new_rows[sel]
            self._chi_chunks[c] = patched
        self._chi_cat = None
        # Device caches update in place (index_copy_), where the JAX store
        # built fresh arrays: device residency tracks the live epoch, and
        # runs pinned to an older one never read it (StaleRunError).
        if self._chi_dev is not None:
            self._chi_dev.index_copy_(0, _index(positions, self.device),
                                      _to_device(new_rows, self.device))
        # pyramid tiers / value stats: patch materialized caches in place
        # (copy-on-write, same as the owning chunks above)
        for g, tab in list(self._chi_tier_host.items()):
            patched_t = tab.copy()
            patched_t[positions] = tier_slice(new_rows, self.cfg.grid, g)
            self._chi_tier_host[g] = patched_t
        for g, tab in list(self._chi_tier_dev.items()):
            tab.index_copy_(0, _index(positions, self.device),
                            _to_device(tier_slice(new_rows, self.cfg.grid, g),
                                       self.device))
        if self._chi_stats is not None:
            stats = self._chi_stats.copy()
            stats[positions] = new_rows[:, -1, -1, :]
            self._chi_stats = stats
        # mask bytes (copy-on-write for memory so pinned views stay intact;
        # the replacement buffer keeps the old spare capacity so the next
        # append stays O(delta))
        if self.tier == "memory":
            self._masks_buf = self._cow_masks_buf(self._masks)
            self._masks = self._masks_buf[:len(self.meta)]
            self._masks[positions] = stored.astype(self._masks.dtype,
                                                   copy=False)
            self._resident = None
        else:
            for mid, m in zip(mask_ids, stored):
                np.save(self._mask_path(mid), m)
            if self._resident is not None:
                res = self._resident.copy()
                res[positions] = stored
                self._resident = res
        if self._device_masks is not None:     # in place, as for the CHI
            self._device_masks.index_copy_(0, _index(positions, self.device),
                                           _to_device(stored, self.device))
        # shared-load cache: the bytes at these positions changed
        if self._cache_map is not None:
            rows = self._cache_map[positions]
            valid = rows >= 0
            if np.any(valid):
                self._cache_map[positions[valid]] = -1
                self._cache_pos[rows[valid]] = -1
                self.cache_stats.invalidations += int(np.count_nonzero(valid))
        if meta is not None:
            fresh_meta = self.meta.copy()
            fresh_meta[positions] = meta
            self.meta = fresh_meta
        self._bump(mask_ids)
        if self.tier == "disk":
            for c in touched_chunks:
                np.save(os.path.join(self.root, self._chunk_files[c]),
                        self._chi_chunks[c])
            if meta is not None:
                np.save(os.path.join(self.root, "meta.npy"), self.meta)
            self._write_config()
        return self.epoch

    def delete(self, mask_ids: Sequence[int]) -> int:
        """Remove masks; surviving rows keep their relative order (positions
        renumber, mask_ids are stable).  Compacts the CHI into one chunk.
        Returns the new epoch."""
        self._check_mutable()
        mask_ids = np.unique(np.atleast_1d(np.asarray(mask_ids, np.int64)))
        positions = self.positions_of(mask_ids)
        if len(positions) == 0:
            return self.epoch
        keep = np.ones(len(self.meta), dtype=bool)
        keep[positions] = False
        keep_idx = np.nonzero(keep)[0]
        # CHI: compact surviving rows into a single chunk
        self._chi_chunks = [np.ascontiguousarray(self.chi_host()[keep])]
        self._chi_cat = None
        if self._chi_dev is not None:
            self._chi_dev = self._chi_dev[_index(keep_idx, self.device)]
        # pyramid tiers / value stats: gather survivors
        for g, tab in list(self._chi_tier_host.items()):
            self._chi_tier_host[g] = np.ascontiguousarray(tab[keep])
        for g, tab in list(self._chi_tier_dev.items()):
            self._chi_tier_dev[g] = tab[_index(keep_idx, self.device)]
        if self._chi_stats is not None:
            self._chi_stats = np.ascontiguousarray(self._chi_stats[keep])
        # mask bytes
        if self.tier == "memory":
            self._masks_buf = self._cow_masks_buf(self._masks[keep])
            self._masks = self._masks_buf[:len(keep_idx)]
            self._resident = None
        else:
            for mid in mask_ids:
                try:
                    os.remove(self._mask_path(mid))
                except FileNotFoundError:
                    pass
            if self._resident is not None:
                self._resident = np.ascontiguousarray(self._resident[keep])
        if self._device_masks is not None:
            self._device_masks = self._device_masks[
                _index(keep_idx, self.device)]
        # shared-load cache: remap surviving positions (cached bytes are
        # still valid — only the numbering moved)
        if self._cache_map is not None:
            newpos = np.cumsum(keep) - 1
            self._cache_map = self._cache_map[keep]
            slot_old = self._cache_pos[:self._cache_used]
            live = slot_old >= 0
            gone = live & ~keep[np.where(live, slot_old, 0)]
            self.cache_stats.invalidations += int(np.count_nonzero(gone))
            remapped = np.where(live & ~gone,
                                newpos[np.where(live, slot_old, 0)], -1)
            self._cache_pos[:self._cache_used] = remapped
        self.meta = self.meta[keep]
        self._bump(mask_ids)
        if self.tier == "disk":
            np.save(os.path.join(self.root, "meta.npy"), self.meta)
            for f in self._chunk_files[1:]:
                try:
                    os.remove(os.path.join(self.root, f))
                except FileNotFoundError:
                    pass
            self._chunk_files = ["chi.npy"]
            np.save(os.path.join(self.root, "chi.npy"), self._chi_chunks[0])
            self._write_config()
        return self.epoch

    def compact_chi(self) -> None:
        """Merge the chunked CHI into one chunk (bounds gather fan-out);
        called automatically once appends fragment past a threshold."""
        if self._chi_chunks is None or len(self._chi_chunks) <= 1:
            return
        self._chi_chunks = [self.chi_host().copy()]
        self._chi_cat = self._chi_chunks[0]
        if self.tier == "disk" and self._chunk_files is not None:
            for f in self._chunk_files:
                if f != "chi.npy":
                    try:
                        os.remove(os.path.join(self.root, f))
                    except FileNotFoundError:
                        pass
            self._chunk_files = ["chi.npy"]
            np.save(os.path.join(self.root, "chi.npy"), self._chi_chunks[0])
            self._write_config()

    # -- resident tiers (backend ingest, not the metered query path) ---------

    def resident_masks(self) -> np.ndarray:
        """All mask bytes as one host array (cached per epoch).

        This is the one-time *ingest* read the device and mesh backends pin
        their resident copy from — deliberately not metered through ``io``:
        the quantity MaskSearch's index minimizes is per-query verification
        I/O, and a resident tier pays its bytes once at load time.
        Mutations keep the copy fresh incrementally (appends concatenate,
        updates patch a copy, deletes compact)."""
        if self._resident is None:
            if self._masks is not None:
                self._resident = np.asarray(self._masks, self.row_dtype)
            else:
                out = np.empty((len(self.meta),) + self.row_shape,
                               self.row_dtype)
                for i in range(len(self.meta)):
                    out[i] = np.load(self._mask_path(self.meta["mask_id"][i]))
                self._resident = out
        return self._resident

    def device_masks(self):
        """:meth:`resident_masks` pinned on the store's device (a torch
        tensor, cached; packed words as their int32 bit view) — the
        HBM-resident tier the device backend verifies against.  Once
        materialized, mutations maintain it incrementally:
        appends copy only the new rows over, updates scatter the changed
        rows in place, deletes gather the survivors."""
        if self._device_masks is None:
            self._device_masks = _to_device(self.resident_masks(),
                                            self.device)
        return self._device_masks

    # -- mask-byte access (the metered path) --------------------------------

    def enable_cache(self, capacity_bytes: int | None = None) -> bool:
        """Turn on the cross-query load cache (hits are not metered — the
        bytes were already paid for by an earlier query in the workload).

        The cache is bounded: at most ``capacity_bytes`` (default 256 MiB)
        of mask rows stay resident; beyond that, rows are evicted FIFO and
        accounted in ``CacheStats.evictions``.

        Idempotent: returns True iff this call newly enabled the cache, so
        nested users (a workload running under the query service, which
        keeps a long-lived cross-session cache) don't clear an outer
        owner's cache on the way out."""
        if self._cache_map is not None:
            return False
        cap_bytes = DEFAULT_CACHE_BYTES if capacity_bytes is None \
            else int(capacity_bytes)
        # Capacity in *stored-representation* rows: a packed store's rows
        # are ~32× smaller, so the same byte budget holds ~32× more masks.
        self._cache_cap = max(cap_bytes // self.row_nbytes, 1)
        self._cache_map = np.full(len(self.meta), -1, dtype=np.int64)
        self._cache_arr = None
        self._cache_pos = np.full(self._cache_cap, -1, dtype=np.int64)
        self._cache_used = 0
        self._cache_clock = 0
        self.cache_stats.reset()
        return True

    def clear_cache(self) -> None:
        self._cache_map = None
        self._cache_arr = None
        self._cache_pos = None
        self._cache_used = 0
        self._cache_clock = 0
        self._cache_cap = 0

    def _read_files(self, mask_ids: np.ndarray) -> np.ndarray:
        """Metered disk-tier read of whole masks by id."""
        loaded = np.empty((len(mask_ids),) + self.row_shape,
                          dtype=self.row_dtype)
        t0 = time.perf_counter()
        nbytes = 0
        for i, mid in enumerate(mask_ids):
            arr = np.load(self._mask_path(mid))
            loaded[i] = arr
            nbytes += arr.nbytes
        self.io.wall_time_s += time.perf_counter() - t0
        self.io.files_read += len(mask_ids)
        self.io.bytes_read += nbytes
        return loaded

    def _read_tier(self, miss_pos: np.ndarray) -> np.ndarray:
        if self.tier in ("memory", "device"):
            loaded = np.asarray(self._masks)[miss_pos]
            self.io.files_read += len(miss_pos)
            self.io.bytes_read += int(loaded.nbytes)
            return loaded
        return self._read_files(self.meta["mask_id"][miss_pos])

    def _cache_insert(self, miss_pos: np.ndarray, loaded: np.ndarray) -> None:
        """Insert loaded rows, filling free capacity first, then FIFO-evicting
        (accounted in ``cache_stats.evictions``)."""
        cap = self._cache_cap
        if cap <= 0:
            return
        if len(miss_pos) > cap:
            drop = len(miss_pos) - cap
            miss_pos, loaded = miss_pos[drop:], loaded[drop:]
        n = len(miss_pos)
        free = cap - self._cache_used
        k = min(free, n)
        if k:
            need = self._cache_used + k
            arr = self._cache_arr
            if arr is None or need > len(arr):
                grow = min(cap, max(need, 2 * (len(arr) if arr is not None
                                               else 128)))
                grown = np.empty((grow,) + self.row_shape, self.row_dtype)
                if arr is not None:
                    grown[:self._cache_used] = arr[:self._cache_used]
                self._cache_arr = arr = grown
            base = self._cache_used
            arr[base:need] = loaded[:k]
            self._cache_pos[base:need] = miss_pos[:k]
            self._cache_map[miss_pos[:k]] = base + np.arange(k)
            self._cache_used = need
        if n > k:
            r = n - k
            slots = (self._cache_clock + np.arange(r)) % cap
            old = self._cache_pos[slots]
            valid = old >= 0
            vo = old[valid]
            still = self._cache_map[vo] == slots[valid]
            self._cache_map[vo[still]] = -1
            self.cache_stats.evictions += int(np.count_nonzero(valid))
            self._cache_arr[slots] = loaded[k:]
            self._cache_pos[slots] = miss_pos[k:]
            self._cache_map[miss_pos[k:]] = slots
            self._cache_clock = int((self._cache_clock + r) % cap)

    def load(self, positions: np.ndarray) -> np.ndarray:
        """Load mask bytes for the given row positions.  On the disk tier
        this is the I/O that the filter-verification framework minimizes."""
        positions = np.asarray(positions, dtype=np.int64)
        if self._cache_map is None:
            return self._read_tier(positions)
        rows = self._cache_map[positions]
        miss = rows < 0
        n_hit = int(np.count_nonzero(~miss))
        self.cache_stats.hits += n_hit
        # bytes_saved in *stored-representation* bytes — exact for float
        # and packed tiers alike (satellite: packed byte metering).
        self.cache_stats.bytes_saved += n_hit * self.row_nbytes
        if not np.any(miss):
            return self._cache_arr[rows]
        miss_pos = np.unique(positions[miss])
        self.cache_stats.misses += len(miss_pos)
        loaded = self._read_tier(miss_pos)
        out = np.empty((len(positions),) + self.row_shape, self.row_dtype)
        if n_hit:
            out[~miss] = self._cache_arr[rows[~miss]]
        out[miss] = loaded[np.searchsorted(miss_pos, positions[miss])]
        self._cache_insert(miss_pos, np.asarray(loaded, self.row_dtype))
        return out

    def load_all(self) -> np.ndarray:
        return self.load(np.arange(len(self)))

    def load_rows(self, positions: np.ndarray, spans: np.ndarray):
        """Partial verification loads (beyond-paper): read only the row span
        each mask's ROI needs, via npy memmap slicing — the disk pays for
        ROI rows, not the whole mask.

        Args:
          positions: (n,) row positions.
          spans: (n, 2) [row_start, row_end) per mask.
        Returns:
          (buf (n, max_span, row_width) in the stored representation —
           float32 pixel rows, or uint32 words on the packed tier; rows
           beyond a mask's span are 0 — and heights (n,) int32).
        Metered: bytes = rows actually read (+4 KiB header/IO floor per
        file under the EBS model's page granularity).
        """
        masks = self._masks if self.tier in ("memory", "device") else None
        return _load_row_spans(self.cfg, self.io, self.meta, masks,
                               self._mask_path, positions, spans,
                               row_width=self.row_shape[1],
                               dtype=self.row_dtype)


class StoreSnapshot:
    """Read-only view of a :class:`MaskStore` pinned at one epoch — the
    snapshot resumable runs hold (DESIGN.md §8).

    Delegation contract: while the store's epoch is unchanged every call is
    forwarded verbatim (shared-load cache, I/O metering, partial-row
    loads).  Once the store moves on:

    * memory-resident tiers keep serving — mutations are copy-on-write at
      the array level, so the pinned ``meta``/mask views are immutable;
    * the disk tier serves reads only while none of the *requested*
      mask_ids was updated or deleted since the pinned epoch, and raises
      :class:`StaleRunError` otherwise (mask files are rewritten in place);
    * the CHI table is construction-time state (bounds passes run at pin
      time), so :attr:`chi_table` refuses to serve a moved store.
    """

    def __init__(self, store: MaskStore):
        self._store = store
        self.epoch = store.epoch
        self.cfg = store.cfg
        self.tier = store.tier
        self.root = store.root
        self.meta = store.meta
        self._masks = store._masks
        # Representation is construction-time state — it never changes
        # across epochs, so the pinned values stay valid forever.
        self.packed = store.packed
        self.device = store.device
        self.words = store.words
        self.row_shape = store.row_shape
        self.row_dtype = store.row_dtype
        self.row_nbytes = store.row_nbytes

    @property
    def fresh(self) -> bool:
        return self.epoch == self._store.epoch

    # -- metering / cache state shared with the live store ------------------
    @property
    def io(self) -> IOStats:
        return self._store.io

    @property
    def cache_stats(self) -> CacheStats:
        return self._store.cache_stats

    @property
    def _cache_map(self):
        # Stale readers must not consult the live cache: its position
        # numbering and contents track the *current* epoch.
        return self._store._cache_map if self.fresh else None

    @property
    def cache_enabled(self) -> bool:
        """Cross-query load cache visibility at the pinned epoch — False
        once the store moves on (the live cache's position numbering
        tracks the current epoch, so a stale reader must not plan
        around it)."""
        return self._cache_map is not None

    @property
    def backend_cache(self) -> dict:
        return self._store.backend_cache

    # -- pinned metadata surface --------------------------------------------
    def __len__(self) -> int:
        return len(self.meta)

    @property
    def mask_ids(self) -> np.ndarray:
        return self.meta["mask_id"]

    def positions_of(self, mask_ids: Sequence[int]) -> np.ndarray:
        return _positions_of(self.meta, mask_ids)

    def select(self, **conds) -> np.ndarray:
        return _select(self.meta, conds)

    @property
    def chi_table(self):
        if not self.fresh:
            raise StaleRunError(
                f"CHI bounds pinned at epoch {self.epoch} cannot be "
                f"recomputed: store moved to epoch {self._store.epoch}")
        return self._store.chi_table

    @property
    def chi_chunks(self) -> list | None:
        """Chunked CHI layout for observability byte accounting — None (not
        an error) once the store moves on; row *sizes* don't change across
        epochs but the freshness contract stays uniform with chi_table."""
        return self._store.chi_chunks if self.fresh else None

    def chi_host(self, positions: np.ndarray | None = None) -> np.ndarray:
        """Host CHI rows at the pinned epoch — same freshness contract as
        :attr:`chi_table` (bounds passes run at pin time)."""
        if not self.fresh:
            raise StaleRunError(
                f"CHI bounds pinned at epoch {self.epoch} cannot be "
                f"recomputed: store moved to epoch {self._store.epoch}")
        return self._store.chi_host(positions)

    def _require_fresh_index(self) -> MaskStore:
        if not self.fresh:
            raise StaleRunError(
                f"CHI bounds pinned at epoch {self.epoch} cannot be "
                f"recomputed: store moved to epoch {self._store.epoch}")
        return self._store

    def chi_tier_host(self, g: int) -> np.ndarray:
        """Pyramid tier at the pinned epoch — same freshness contract as
        :attr:`chi_table` (the refinement ladder runs at pin time)."""
        return self._require_fresh_index().chi_tier_host(g)

    def chi_tier_table(self, g: int):
        return self._require_fresh_index().chi_tier_table(g)

    def chi_value_stats(self) -> np.ndarray:
        """Build-time index statistics at the pinned epoch (cost model)."""
        return self._require_fresh_index().chi_value_stats()

    def snapshot(self) -> "StoreSnapshot":
        return self

    # -- byte reads at the pinned epoch -------------------------------------
    def _require_clean(self, positions: np.ndarray) -> np.ndarray:
        ids = self.meta["mask_id"][positions]
        if self._store.ids_dirty_since(self.epoch, ids):
            raise StaleRunError(
                f"run pinned at epoch {self.epoch} needs mask bytes that "
                f"were rewritten (store at epoch {self._store.epoch})")
        return ids

    def can_serve(self, positions: np.ndarray) -> bool:
        """Whether :meth:`load` for these positions would succeed — True
        while fresh or memory-resident; for the disk tier, while none of
        the positions' mask_ids moved since the pinned epoch."""
        if self.fresh or self._masks is not None:
            return True
        positions = np.asarray(positions, dtype=np.int64)
        ids = self.meta["mask_id"][positions]
        return not self._store.ids_dirty_since(self.epoch, ids)

    def load(self, positions: np.ndarray) -> np.ndarray:
        if self.fresh:
            return self._store.load(positions)
        positions = np.asarray(positions, dtype=np.int64)
        if self._masks is not None:
            loaded = np.asarray(self._masks)[positions]
            self.io.files_read += len(positions)
            self.io.bytes_read += int(loaded.nbytes)
            return loaded
        ids = self._require_clean(positions)
        return self._store._read_files(ids)

    def load_all(self) -> np.ndarray:
        return self.load(np.arange(len(self)))

    def load_rows(self, positions: np.ndarray, spans: np.ndarray):
        if self.fresh:
            return self._store.load_rows(positions, spans)
        positions = np.asarray(positions, dtype=np.int64)
        if self._masks is None:
            self._require_clean(positions)
        return _load_row_spans(self.cfg, self.io, self.meta, self._masks,
                               self._store._mask_path, positions, spans,
                               row_width=self.row_shape[1],
                               dtype=self.row_dtype)
