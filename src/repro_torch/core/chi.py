"""CHI — the Cumulative Histogram Index (the paper's core contribution).

For every mask, pixel values are discretized against an ordered threshold set
Θ and the spatial domain is cut into a ``G×G`` grid.  CHI stores cumulative
pixel counts for every (spatial-prefix, threshold-prefix) key.  We lay the
same information out as a dense 3-D prefix-sum tensor per mask::

    table[b, i, j, k] = #{ pixels p of mask b :
                           p.row < row_bounds[i],
                           p.col < col_bounds[j],
                           p.value < edges[k] }

with ``table.shape == (B, G+1, G+1, NB+1)`` — an O(1) 8-corner gather answers
the count of any *aligned* (cell-rectangle × threshold-range), and arbitrary
queries get sound upper/lower bounds by sandwiching the ROI between the
largest inscribed and smallest covering aligned boxes (same for the value
range).  This dense layout is the device-friendly equivalent of the paper's
key-value CHI: contiguous, gather-vectorizable across the whole mask batch.

Tables live as numpy on the host and as int32 torch tensors on the store's
device; the bounds math below runs on whichever device the table is on.

Soundness invariants (property-tested in ``tests/test_chi.py``):
  * ``lower(b) <= CP_exact(b) <= upper(b)`` always;
  * aligned queries are answered exactly (``lower == upper``).

Value-edge sentinels: interior thresholds live in ``(0, 1)``; edge 0 is −inf
and edge NB is +inf so the index stays sound even for masks containing
values outside ``[0, 1)`` (e.g. exactly 1.0 for binarized masks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CHIConfig:
    """Static index parameters (shared by every mask in a store partition)."""

    grid: int = 16           # G — spatial cells per side
    num_bins: int = 16       # NB — value bins
    height: int = 256        # mask height in pixels
    width: int = 256         # mask width in pixels
    # Interior value thresholds (len NB-1).  None → uniform in (0, 1).
    thresholds: tuple[float, ...] | None = None

    @property
    def row_bounds(self) -> np.ndarray:
        g = self.grid
        return np.array([(i * self.height) // g for i in range(g + 1)], dtype=np.int64)

    @property
    def col_bounds(self) -> np.ndarray:
        g = self.grid
        return np.array([(j * self.width) // g for j in range(g + 1)], dtype=np.int64)

    @property
    def interior_edges(self) -> np.ndarray:
        """The NB-1 interior thresholds (finite, sorted)."""
        if self.thresholds is not None:
            t = np.asarray(self.thresholds, dtype=np.float32)
            if t.shape != (self.num_bins - 1,):
                raise ValueError(
                    f"need {self.num_bins - 1} interior thresholds, got {t.shape}")
            if np.any(np.diff(t) <= 0):
                raise ValueError("thresholds must be strictly increasing")
            return t
        nb = self.num_bins
        return (np.arange(1, nb, dtype=np.float32)) / np.float32(nb)

    @property
    def edges(self) -> np.ndarray:
        """(NB+1,) value edges with ±inf sentinels."""
        return np.concatenate(
            [[-np.inf], self.interior_edges.astype(np.float64), [np.inf]])

    def table_shape(self, batch: int) -> tuple[int, int, int, int]:
        return (batch, self.grid + 1, self.grid + 1, self.num_bins + 1)

    def index_bytes(self, batch: int) -> int:
        return int(np.prod(self.table_shape(batch))) * 4

    def mask_bytes(self, batch: int) -> int:
        return batch * self.height * self.width * 4

    @property
    def tier_grids(self) -> tuple[int, ...]:
        """Pyramid tiers, coarsest first, finest == ``grid`` (DESIGN.md §13).

        Each coarser tier halves the grid while it stays even and >= 4, so
        every coarse boundary is also a fine boundary (``(i*H)//g`` with
        ``g | grid`` is a subset of the fine boundary set) and the coarse
        table is an exact strided subsample of the fine one — no extra
        persisted state, nesting sound by construction.  A grid that cannot
        halve (odd, or already 4) is a single-tier pyramid, which disables
        the refinement ladder entirely.
        """
        g, tiers = self.grid, [self.grid]
        while g % 2 == 0 and g // 2 >= 4:
            g //= 2
            tiers.append(g)
        return tuple(reversed(tiers))

    def for_grid(self, g: int) -> "CHIConfig":
        """The same index geometry at tier ``g`` (value bins unchanged)."""
        if g == self.grid:
            return self
        if self.grid % g:
            raise ValueError(f"tier grid {g} does not divide grid {self.grid}")
        return dataclasses.replace(self, grid=g)


# ---------------------------------------------------------------------------
# Index construction
# ---------------------------------------------------------------------------


def cell_histograms(masks: Array, cfg: CHIConfig) -> Array:
    """(B, G, G, NB) int32 per-cell per-bin pixel counts of a torch batch,
    through the ``chi_cell_hist`` kernel wrapper: the CUDA kernel for a
    tensor on the card, its plain torch version on the CPU.  Ragged
    geometry (G ∤ H) is served by both."""
    b, h, w = masks.shape
    if (h, w) != (cfg.height, cfg.width):
        raise ValueError(f"mask shape {(h, w)} != cfg {(cfg.height, cfg.width)}")
    from ..kernels import ops as kops
    return kops.chi_cell_hist(masks, torch.as_tensor(cfg.interior_edges),
                              cfg.grid)


def histograms_to_table(cell_hist: Array) -> Array:
    """Convert (B, G, G, NB) cell counts into the (B, G+1, G+1, NB+1) CHI
    prefix-sum table via three cumulative sums + zero padding."""
    c = torch.cumsum(cell_hist, dim=1)
    c = torch.cumsum(c, dim=2)
    c = torch.cumsum(c, dim=3)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0, 1, 0))
    return c.to(torch.int32)


def build_chi(masks: Array, cfg: CHIConfig) -> Array:
    """Build the CHI table for a torch batch of masks on its device."""
    return histograms_to_table(cell_histograms(masks, cfg))


def build_chi_delta(masks: np.ndarray, cfg: CHIConfig,
                    device="cuda") -> np.ndarray:
    """CHI table rows for a *delta* batch — the incremental-ingest primitive
    behind :meth:`repro_torch.core.store.MaskStore.append`/``update``.

    Cost is O(len(masks)), never O(database): the caller attaches the
    returned ``(delta, G+1, G+1, NB+1)`` rows as a new chunk (append) or
    patches them into existing chunks (update).  On a CUDA device the
    histograms go through the ``chi_build`` CUDA kernel; on the CPU the
    NumPy oracle builds them — the JAX package's policy (kernel on
    accelerators, NumPy on plain CPU).
    """
    masks = np.asarray(masks, np.float32)
    if masks.ndim == 2:
        masks = masks[None]
    if len(masks) == 0:
        return np.zeros(cfg.table_shape(0), np.int32)
    if torch.device(device).type == "cuda":
        table = build_chi(torch.from_numpy(masks).to(device), cfg)
        return table.cpu().numpy()
    return build_chi_np(masks, cfg)


def build_chi_np(masks: np.ndarray, cfg: CHIConfig) -> np.ndarray:
    """Numpy oracle for :func:`build_chi` (used in tests + host-side ingest)."""
    b, h, w = masks.shape
    g, nb = cfg.grid, cfg.num_bins
    interior = cfg.interior_edges.astype(np.float64)
    bins = np.searchsorted(interior, masks.astype(np.float64), side="right")
    rb, cb = cfg.row_bounds, cfg.col_bounds
    row_cell = np.clip(np.searchsorted(rb, np.arange(h), side="right") - 1, 0, g - 1)
    col_cell = np.clip(np.searchsorted(cb, np.arange(w), side="right") - 1, 0, g - 1)
    out = np.zeros((b, g, g, nb), dtype=np.int64)
    flat = (row_cell[:, None] * g + col_cell[None, :])[None] * nb + bins
    for i in range(b):
        out[i] = np.bincount(flat[i].reshape(-1), minlength=g * g * nb).reshape(g, g, nb)
    tab = out.cumsum(axis=1).cumsum(axis=2).cumsum(axis=3)
    tab = np.pad(tab, ((0, 0), (1, 0), (1, 0), (1, 0)))
    return tab.astype(np.int32)


# ---------------------------------------------------------------------------
# Hierarchical pyramid tiers (DESIGN.md §13)
# ---------------------------------------------------------------------------


def tier_slice(table: np.ndarray, grid: int, g: int) -> np.ndarray:
    """The exact tier-``g`` CHI table, sliced out of the tier-``grid`` one.

    Because ``row_bounds[i] = (i*H)//g`` and ``g | grid``, every tier-``g``
    boundary equals the fine boundary at index ``i * (grid // g)`` —
    ``(i*(grid//g)*H)//grid == (i*H)//g`` exactly — so the coarse table is
    a strided subsample of the fine prefix tensor, not an approximation.
    Coarse-tier bounds therefore contain fine-tier bounds by construction.
    """
    if grid % g:
        raise ValueError(f"tier grid {g} does not divide grid {grid}")
    r = grid // g
    out = table[:, ::r, ::r, :]
    if isinstance(out, np.ndarray):
        out = np.ascontiguousarray(out)
    return out


def value_ks4(cfg: CHIConfig, lv: float, uv: float) -> tuple[int, int, int, int]:
    """The four clipped value-edge indices of :func:`resolve_query` —
    ``(kl_in, ku_in, kl_out, ku_out)`` — shared with the cost model so the
    searchsorted-on-edges logic stays in this module."""
    edges = cfg.edges
    nb = cfg.num_bins
    kl_in = int(np.clip(np.searchsorted(edges, lv, side="left"), 0, nb))
    ku_in = int(np.clip(np.searchsorted(edges, uv, side="right") - 1, 0, nb))
    kl_out = int(np.clip(np.searchsorted(edges, lv, side="right") - 1, 0, nb))
    ku_out = int(np.clip(np.searchsorted(edges, uv, side="left"), 0, nb))
    return kl_in, ku_in, kl_out, ku_out


def tier_alignment_fracs(cfg: CHIConfig, g: int, rois: np.ndarray):
    """Per-ROI (inner, outer) aligned-area fractions at tier ``g``.

    ``inner`` is the area of the largest tier-aligned box inscribed in the
    ROI and ``outer`` the smallest covering one, both divided by the ROI
    area — the spatial slack the cost model uses to predict how many
    candidates a tier can decide (inner == outer == 1 means the tier
    answers the ROI exactly).  Empty ROIs report (1, 1): they are always
    decided.  Same boundary math as :func:`resolve_query`, kept here so
    searchsorted over index geometry stays in this module.
    """
    tcfg = cfg.for_grid(g)
    rb, cb = tcfg.row_bounds, tcfg.col_bounds
    rois = np.asarray(rois, np.int64)
    r0, c0, r1, c1 = rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 3]
    gi = tcfg.grid

    def _spans(bounds, lo, hi):
        il = np.clip(np.searchsorted(bounds, lo, side="left"), 0, gi)
        ih = np.clip(np.searchsorted(bounds, hi, side="right") - 1, 0, gi)
        ol = np.clip(np.searchsorted(bounds, lo, side="right") - 1, 0, gi)
        oh = np.clip(np.searchsorted(bounds, hi, side="left"), 0, gi)
        inner = np.maximum(bounds[ih] - bounds[il], 0)
        outer = np.maximum(bounds[oh] - bounds[ol], 0)
        return inner, outer

    in_h, out_h = _spans(rb, r0, r1)
    in_w, out_w = _spans(cb, c0, c1)
    area = np.maximum(r1 - r0, 0) * np.maximum(c1 - c0, 0)
    safe = np.maximum(area, 1).astype(np.float64)
    inner = np.where(area > 0, (in_h * in_w) / safe, 1.0)
    outer = np.where(area > 0, (out_h * out_w) / safe, 1.0)
    return inner, outer


# ---------------------------------------------------------------------------
# Aligned lookups and query bounds
# ---------------------------------------------------------------------------


def _lookup(table: Array, i0, i1, j0, j1, k0, k1) -> Array:
    """Exact count over aligned box [i0,i1)×[j0,j1) cells × [k0,k1) bins.

    Index args are (B,) integer tensors (or Python ints broadcastable to
    them); the answer is an 8-corner inclusion–exclusion gather — O(1) per
    mask.
    """
    b = table.shape[0]
    bi = torch.arange(b, device=table.device)

    def f(i, j, k):
        return table[bi, i, j, k]

    def plane(k):
        return f(i1, j1, k) - f(i0, j1, k) - f(i1, j0, k) + f(i0, j0, k)

    return plane(k1) - plane(k0)


@dataclasses.dataclass(frozen=True)
class AlignedQuery:
    """Host-side resolution of an arbitrary (roi, value-range) query against
    the index geometry: inscribed + covering aligned boxes."""

    # inner (inscribed) spatial box, cell indices
    il: np.ndarray; ih: np.ndarray; jl: np.ndarray; jh: np.ndarray
    # outer (covering) spatial box
    ol: np.ndarray; oh: np.ndarray; pl: np.ndarray; ph: np.ndarray
    # inner / outer value-bin ranges (scalars)
    kl_in: int; ku_in: int; kl_out: int; ku_out: int
    roi_area: np.ndarray  # (B,) pixel area, caps the upper bound
    aligned: np.ndarray   # (B,) bool — query exactly aligned to the index


def resolve_query(cfg: CHIConfig, rois: np.ndarray, lv: float, uv: float) -> AlignedQuery:
    """Map pixel-space ROIs + a value range onto index coordinates (host side;
    boundary arrays are tiny so numpy searchsorted is the right tool)."""
    rb, cb, edges = cfg.row_bounds, cfg.col_bounds, cfg.edges
    r0, c0, r1, c1 = rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 3]
    # inner: smallest boundary >= start, largest boundary <= end
    il = np.searchsorted(rb, r0, side="left")
    ih = np.searchsorted(rb, r1, side="right") - 1
    jl = np.searchsorted(cb, c0, side="left")
    jh = np.searchsorted(cb, c1, side="right") - 1
    # outer: largest boundary <= start, smallest boundary >= end
    ol = np.searchsorted(rb, r0, side="right") - 1
    oh = np.searchsorted(rb, r1, side="left")
    pl = np.searchsorted(cb, c0, side="right") - 1
    ph = np.searchsorted(cb, c1, side="left")

    kl_in = int(np.searchsorted(edges, lv, side="left"))
    ku_in = int(np.searchsorted(edges, uv, side="right") - 1)
    kl_out = int(np.searchsorted(edges, lv, side="right") - 1)
    ku_out = int(np.searchsorted(edges, uv, side="left"))

    nbp1 = cfg.num_bins
    kl_in, ku_in = np.clip(kl_in, 0, nbp1), np.clip(ku_in, 0, nbp1)
    kl_out, ku_out = np.clip(kl_out, 0, nbp1), np.clip(ku_out, 0, nbp1)

    g = cfg.grid
    area = np.maximum(r1 - r0, 0) * np.maximum(c1 - c0, 0)
    spatial_aligned = (il == ol) & (ih == oh) & (jl == pl) & (jh == ph)
    value_aligned = (kl_in == kl_out) and (ku_in == ku_out)
    empty = area == 0
    return AlignedQuery(
        il=np.clip(il, 0, g), ih=np.clip(ih, 0, g),
        jl=np.clip(jl, 0, g), jh=np.clip(jh, 0, g),
        ol=np.clip(ol, 0, g), oh=np.clip(oh, 0, g),
        pl=np.clip(pl, 0, g), ph=np.clip(ph, 0, g),
        kl_in=int(kl_in), ku_in=int(ku_in),
        kl_out=int(kl_out), ku_out=int(ku_out),
        roi_area=area.astype(np.int64),
        aligned=(spatial_aligned & value_aligned) | empty,
    )


def _bounds_device(table, il, ih, jl, jh, ol, oh, pl, ph, area,
                   kl_in: int, ku_in: int, kl_out: int, ku_out: int):
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    inner_nonempty = (ih > il) & (jh > jl) & (ku_in > kl_in)
    lb_raw = _lookup(table, il, ih, jl, jh, min(kl_in, ku_in), ku_in)
    lb = torch.where(inner_nonempty, lb_raw, zero)
    outer_nonempty = (oh > ol) & (ph > pl) & (ku_out > kl_out)
    ub_raw = _lookup(table, ol, oh, pl, ph, min(kl_out, ku_out), ku_out)
    ub = torch.where(outer_nonempty, ub_raw, zero)
    ub = torch.minimum(ub, area.to(ub.dtype))
    lb = torch.minimum(lb, ub)  # inner ⊆ outer, but guard rounding pathologies
    return lb.to(torch.int32), ub.to(torch.int32)


def chi_bounds(table: Array, cfg: CHIConfig, rois, lv: float, uv: float):
    """Sound (lower, upper) bounds on ``CP(mask, roi, [lv, uv))`` for every
    mask in the indexed batch — no mask bytes touched.

    Returns ``(lb, ub)`` int32 arrays of shape ``(B,)``.
    """
    b = table.shape[0]
    rois = np.asarray(rois, dtype=np.int64)
    if rois.ndim == 1:
        rois = np.tile(rois[None], (b, 1))
    q = resolve_query(cfg, rois, lv, uv)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.int64)).to(table.device)

    lb, ub = _bounds_device(
        table,
        dev(q.il), dev(q.ih), dev(q.jl), dev(q.jh),
        dev(q.ol), dev(q.oh), dev(q.pl), dev(q.ph),
        dev(q.roi_area),
        kl_in=q.kl_in, ku_in=q.ku_in, kl_out=q.kl_out, ku_out=q.ku_out,
    )
    return lb, ub
