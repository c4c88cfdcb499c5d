"""Distributed MaskSearch — the query engine sharded over a device mesh.

The paper's prototype is single-node; this module is the beyond-paper
scale-out.  The mask DB (mask bytes + CHI tables + ROI table) is sharded
row-wise over every mesh axis (a DB of N masks becomes N/num_devices rows
per device).  The *step* functions below cover the engine's hot paths:

  * ``filter_bounds_step`` — CHI bounds + predicate verdicts for every local
    row, with global accept/undecided counts.
  * ``verify_step``        — exact CP over a dense batch of survivor masks
    (the ``cp_count`` kernel on each shard).
  * ``topk_step``          — bound-driven distributed top-k: per-shard top-k
    over upper bounds, a gather of k candidates per shard, global threshold
    τ = k-th best lower bound, survivor flags.
  * ``iou_agg_step``       — group IoU from the ``mask_agg_counts`` kernel's
    counts.

plus the steps :class:`repro_torch.core.backend.MeshBackend` drives from the
public query path (``run_plan(plan, backend="mesh")``): the CP-leaf and
pair-cell bounds, the ranking frontier's selection, multi-descriptor CP,
MASK_AGG and pair counts, and the packed tier's popcount steps.

Design: one process owns the mesh and runs each step shard by shard, as
``shard_map`` does in the JAX package.  A row-local step runs its function
on each shard's device (the kernels of :mod:`repro_torch.kernels.ops`: the
CUDA kernel on a CUDA shard, its plain version on a CPU shard) and
concatenates the results in shard order on ``mesh.devices[0]``; the
``all_gather`` of the two top-k steps is that concatenation.  A mesh's
device list may repeat one device: its shards are then logical shards on
that device, run one after another on its default stream.  The mesh keeps
nothing resident between steps: each step places its host inputs on the
shards' devices (``Mesh.placed_bytes`` counts those bytes).

Device placement convention: rows are sharded over the flattened mesh
(``("data", "model")`` of shape (2, 4) is 8 row shards); nothing is
replicated except the query descriptor scalars and the grid boundaries.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from . import chi as chi_lib
from . import packing
from .exprs import cell_counts_torch, pair_cell_bounds_torch


class Mesh:
    """A device mesh: its shape, axis names and the flat, row-major list of
    devices, one per shard (a device may appear more than once)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence):
        self.shape = dict(zip(axis_names, (int(s) for s in shape)))
        self.axis_names = tuple(axis_names)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.shape) != len(tuple(shape)):
            raise ValueError(f"{len(tuple(shape))} mesh dims need as many "
                             f"distinct axis names, got {self.axis_names}")
        if int(np.prod(tuple(shape))) != len(self.devices):
            raise ValueError(f"mesh shape {tuple(shape)} needs "
                             f"{int(np.prod(tuple(shape)))} devices, got "
                             f"{len(self.devices)}")
        self.placed_bytes = 0   # host bytes the steps placed on shards

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"devices=[{', '.join(str(d) for d in self.devices)}])")


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """Every visible device of one type: ``cuda:0..n-1`` (the default;
    raises when no card is visible), or the one CPU device."""
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass the mesh's "
                               "devices (e.g. [\"cpu\"] * n) to run it on "
                               "the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (by default
    :func:`local_devices`: every card, raising when none is visible).
    Repeat a device to shard over it logically, e.g. ``make_mesh((8,),
    ("data",), ["cpu"] * 8)``."""
    return Mesh(shape, axes, local_devices() if devices is None else devices)


def db_axes(mesh: Mesh) -> tuple[str, ...]:
    """All mesh axes — DB rows shard over the full device set."""
    return tuple(mesh.axis_names)


class Sharding:
    """Where an array lives on a mesh: its leading dim split over ``axes``
    (all of the mesh's: ``n_dev`` equal contiguous shards, shard i on
    ``mesh.devices[i]``), or a whole copy on every device (``axes=()``)."""

    def __init__(self, mesh: Mesh, axes: tuple[str, ...], ndim=None):
        self.mesh = mesh
        self.axes = axes
        self.ndim = ndim

    def put(self, x) -> "Sharded":
        x = _tensor(x)
        if self.ndim is not None and x.dim() != self.ndim:
            raise ValueError(f"expected a {self.ndim}-d array, got shape "
                             f"{tuple(x.shape)}")
        if self.axes:
            parts = _split(x, 0, self.mesh.size)
        else:
            parts = [x] * self.mesh.size
        return Sharded(self, [_place(self.mesh, p, d)
                              for p, d in zip(parts, self.mesh.devices)])


class Sharded:
    """An array placed by a :class:`Sharding`: one tensor per device."""

    def __init__(self, sharding: Sharding, shards: list):
        self.sharding = sharding
        self.shards = shards

    @property
    def shape(self) -> tuple:
        s = self.shards[0].shape
        if not self.sharding.axes:
            return tuple(s)
        return (sum(t.shape[0] for t in self.shards),) + tuple(s[1:])


def row_sharding(mesh: Mesh, ndim: int) -> Sharding:
    return Sharding(mesh, db_axes(mesh), ndim)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def device_put(x, sharding: Sharding) -> Sharded:
    """``x`` (numpy or torch) placed on the mesh as ``sharding`` says."""
    return sharding.put(x)


# ---------------------------------------------------------------------------
# The single-controller shard map
# ---------------------------------------------------------------------------

# How a step's argument or output is laid out over the shards.
ROW = 0         # leading dim split over every device
COL = 1         # dim 1 split: the batch axis of (Q, B, …) descriptors
REP = None      # replicated: each shard sees the whole value


def _tensor(x) -> torch.Tensor:
    """A host array as a CPU tensor (packed uint32 words as their int32 bit
    view, no copy); a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(packing.torch_bits(np.asarray(x)))


def _split(x: torch.Tensor, axis: int, n: int) -> list:
    rows = x.shape[axis]
    if rows % n:
        raise ValueError(f"{rows} rows do not split into {n} equal shards; "
                         f"pad them to a multiple first")
    return list(torch.split(x, rows // n, dim=axis))


def _place(mesh: Mesh, part: torch.Tensor, dev: torch.device):
    """One shard on its device, contiguous; counts the bytes a host part
    carries there."""
    if part.device.type == "cpu":
        mesh.placed_bytes += part.numel() * part.element_size()
    return part.to(dev).contiguous()


def _shards(mesh: Mesh, x, spec) -> list:
    """Argument ``x`` as one value per shard."""
    if isinstance(x, Sharded):
        if x.sharding.mesh is not mesh:
            raise ValueError("array is placed on another mesh")
        if bool(x.sharding.axes) != (spec is not REP):
            raise ValueError("array's sharding does not match the step's")
        return x.shards
    if spec is REP:
        return [x] * mesh.size
    parts = _split(_tensor(x), spec, mesh.size)
    return [_place(mesh, p, d) for p, d in zip(parts, mesh.devices)]


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (kernels launch on its
    stream); nothing for other devices."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _concat(mesh: Mesh, outs: list, axis: int) -> torch.Tensor:
    home = mesh.devices[0]
    return torch.cat([o.to(home) for o in outs], dim=axis)


def shard_map(mesh: Mesh, fn, in_specs, out_specs):
    """``fn`` run on every shard of ``mesh`` in turn: argument i split as
    ``in_specs[i]`` says, each output concatenated along ``out_specs``
    (a tuple for a tuple of outputs, else one spec)."""

    def mapped(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"step takes {len(in_specs)} arguments, got "
                            f"{len(args)}")
        per_arg = [_shards(mesh, a, s) for a, s in zip(args, in_specs)]
        outs = []
        for i, dev in enumerate(mesh.devices):
            with _on(dev):
                outs.append(fn(*[p[i] for p in per_arg]))
        if isinstance(out_specs, tuple):
            return tuple(_concat(mesh, [o[j] for o in outs], s)
                         for j, s in enumerate(out_specs))
        return _concat(mesh, outs, out_specs)

    return mapped


def _ints(x) -> list:
    """A small replicated integer vector (value-edge indices) as Python
    ints, from numpy or a tensor."""
    return [int(v) for v in torch.as_tensor(x).reshape(-1).tolist()]


def _scalar(x) -> torch.Tensor:
    """A replicated scalar as a jitted JAX step takes it: float32 if it is
    a float, else int32 (an int32 bound then compares with a fractional
    threshold in float32, as in JAX)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(torch.float32 if t.is_floating_point() else torch.int32)


def _bounds_on(x, dev) -> torch.Tensor:
    """Grid boundaries as an int32 tensor on ``dev``."""
    return torch.as_tensor(x, dtype=torch.int32).to(dev)


# ---------------------------------------------------------------------------
# Step functions (device-side hot paths)
# ---------------------------------------------------------------------------


def _bounds_from_corners(table, corners, area, kl_in, ku_in, kl_out, ku_out):
    """Same 8-corner math as chi._bounds_device, but with corner indices as
    device tensors (computed on device from boundary tables) so the whole
    bounds pass stays on the device.  The value-edge indices are Python
    ints."""
    il, ih, jl, jh, ol, oh, pl, ph = [corners[:, i] for i in range(8)]
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    inner_ok = (ih > il) & (jh > jl) & (ku_in > kl_in)
    lb = torch.where(inner_ok,
                     chi_lib._lookup(table, il, ih, jl, jh,
                                     min(kl_in, ku_in), ku_in), zero)
    outer_ok = (oh > ol) & (ph > pl) & (ku_out > kl_out)
    ub = torch.where(outer_ok,
                     chi_lib._lookup(table, ol, oh, pl, ph,
                                     min(kl_out, ku_out), ku_out), zero)
    ub = torch.minimum(ub, area.to(ub.dtype))
    lb = torch.minimum(lb, ub)
    return lb.to(torch.int32), ub.to(torch.int32)


def device_resolve(rois, row_bounds, col_bounds):
    """Device-side resolve_query: map pixel ROIs onto grid corners.

    rois (N, 4) int32; boundary tables (G+1,) int32 (tiny).
    Returns corners (N, 8) int64 + area (N,) int32.
    """
    r0, c0, r1, c1 = (rois[:, i].contiguous() for i in range(4))

    def ss(bounds, x, right):
        return torch.searchsorted(bounds, x, right=right)

    il = ss(row_bounds, r0, False)
    ih = ss(row_bounds, r1, True) - 1
    jl = ss(col_bounds, c0, False)
    jh = ss(col_bounds, c1, True) - 1
    ol = ss(row_bounds, r0, True) - 1
    oh = ss(row_bounds, r1, False)
    pl = ss(col_bounds, c0, True) - 1
    ph = ss(col_bounds, c1, False)
    g = row_bounds.shape[0] - 1
    corners = torch.stack([il, ih, jl, jh, ol, oh, pl, ph], dim=1)
    corners = corners.clamp(0, g)
    area = ((r1 - r0).clamp(min=0) * (c1 - c0).clamp(min=0)).to(torch.int32)
    return corners, area


def _chi_bounds(tables, rois, row_bounds, col_bounds, ks):
    """(lb, ub) int32 of one shard's CHI rows: corners resolved on the
    shard's device, then the 8-corner lookup."""
    dev = tables.device
    corners, area = device_resolve(rois.to(torch.int32),
                                   _bounds_on(row_bounds, dev),
                                   _bounds_on(col_bounds, dev))
    return _bounds_from_corners(tables, corners, area, *_ints(ks))


def make_filter_bounds_step(mesh: Mesh, op: str = "<"):
    """The distributed bounds+verdict pass.

    Signature: (chi_tables (N,G+1,G+1,NB+1), rois (N,4), row_bounds, col_bounds,
                value_ks (4,) int32 [kl_in,ku_in,kl_out,ku_out], threshold ())
      → accept (N,) bool, undecided (N,) bool, counts (2,) int32 global.
    """

    def local(tables, rois, row_bounds, col_bounds, ks, threshold):
        lb, ub = _chi_bounds(tables, rois, row_bounds, col_bounds, ks)
        if op in ("<", "<="):
            accept = (ub < threshold) if op == "<" else (ub <= threshold)
            reject = (lb >= threshold) if op == "<" else (lb > threshold)
        else:
            accept = (lb > threshold) if op == ">" else (lb >= threshold)
            reject = (ub <= threshold) if op == ">" else (ub < threshold)
        return accept, ~(accept | reject)

    mapped = shard_map(mesh, local, (ROW, ROW, REP, REP, REP, REP),
                       (ROW, ROW))

    def step(tables, rois, row_bounds, col_bounds, ks, threshold):
        accept, undecided = mapped(tables, rois, row_bounds, col_bounds, ks,
                                   _scalar(threshold))
        counts = torch.stack([accept.sum(dtype=torch.int32),
                              undecided.sum(dtype=torch.int32)])
        return accept, undecided, counts

    return step


def make_verify_step(mesh: Mesh):
    """Exact CP over a dense survivor batch, rows sharded over all devices.

    Signature: (masks (V,H,W), rois (V,4), lv (), uv ()) → counts (V,) int32.
    Each shard runs the ``cp_count`` kernel (its plain version on a CPU
    shard).
    """
    return shard_map(mesh, kops.cp_count, (ROW, ROW, REP, REP), ROW)


def _top(x: torch.Tensor, k: int):
    """The k largest of ``x`` and their indices, ties to the lower index
    (``lax.top_k``'s order): a stable descending sort, then a slice —
    ``torch.topk`` does not promise an order among ties, and int32 CHI
    bounds tie constantly on blobby masks."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def make_topk_step(mesh: Mesh, k: int, desc: bool = True):
    """Bound-driven distributed top-k candidate selection.

    Per shard: bounds → local top-k upper bounds (optimistic candidates)
    and local top-k lower bounds (pessimistic threshold contributors).  The
    gather of both merges them; τ = k-th best gathered lower bound; every
    row with ub ≥ τ survives to verification.  Every shard must hold at
    least k rows.

    Signature: (chi_tables, rois, row_bounds, col_bounds, value_ks, base_ids)
      → (cand_vals (D*k,), cand_ids (D*k,), tau (), survivors (N,) bool)
    """

    def local(tables, rois, row_bounds, col_bounds, ks, base_ids):
        if tables.shape[0] < k:
            raise ValueError(f"a shard of {tables.shape[0]} rows has no "
                             f"top-{k}")
        lb, ub = _chi_bounds(tables, rois, row_bounds, col_bounds, ks)
        score_opt = ub if desc else -lb
        score_pes = lb if desc else -ub
        top_opt, idx_opt = _top(score_opt, k)
        top_pes, _ = _top(score_pes, k)
        return top_opt, base_ids[idx_opt], top_pes, score_opt

    mapped = shard_map(mesh, local, (ROW, ROW, REP, REP, REP, ROW),
                       (ROW, ROW, ROW, ROW))

    def step(tables, rois, row_bounds, col_bounds, ks, base_ids):
        cand_vals, cand_ids, gathered_pes, score_opt = mapped(
            tables, rois, row_bounds, col_bounds, ks, base_ids)
        # τ: k-th best pessimistic score globally
        tau = _top(gathered_pes, k)[0][-1]
        return cand_vals, cand_ids, tau, score_opt >= tau

    return step, mesh.size * k


def value_ks(cfg: chi_lib.CHIConfig, lv: float, uv: float) -> np.ndarray:
    """Resolve a value range onto CHI bin edges as the 4-vector
    ``[kl_in, ku_in, kl_out, ku_out]`` (inner/outer threshold-prefix
    indices) — the host-side half of a device bounds pass.  Matches
    :func:`repro_torch.core.chi.resolve_query`'s value resolution exactly."""
    edges = cfg.edges
    kl_in = np.searchsorted(edges, lv, side="left")
    ku_in = np.searchsorted(edges, uv, side="right") - 1
    kl_out = np.searchsorted(edges, lv, side="right") - 1
    ku_out = np.searchsorted(edges, uv, side="left")
    return np.clip(np.array([kl_in, ku_in, kl_out, ku_out], dtype=np.int32),
                   0, cfg.num_bins)


def make_chi_bounds_step(mesh: Mesh):
    """The CP-leaf bounds pass, sharded: CHI tables in, (lb, ub) out.

    Collective-free (each row's 8-corner gather is local); this is what the
    mesh backend runs once per distinct CP term of a plan — the generic
    analogue of ``filter_bounds_step``, which additionally folds in one
    comparison verdict.

    Signature: (chi_tables (N,G+1,G+1,NB+1), rois (N,4), row_bounds,
                col_bounds, value_ks (4,) int32) → lb (N,), ub (N,) int32.
    """
    return shard_map(mesh, _chi_bounds, (ROW, ROW, REP, REP, REP),
                     (ROW, ROW))


def make_topk_select_step(mesh: Mesh, k: int):
    """Distributed selection of the global k-th best pessimistic score.

    The collective at the heart of ``topk_step``, but over *precomputed*
    bounds scores instead of re-deriving them from CHI tables — so any
    ranking expression the plan IR can express (ratios, sums of CPs)
    shards.  Per shard: mask non-definite rows to −inf, local top-k; the
    gather of (value, row-id) pairs, global top-k.  Returns the *row id* of
    the k-th best so the caller can read the threshold τ back at full host
    precision rather than float32 (within a float32 tie class the pick is
    arbitrary; the caller resolves τ from the whole class).

    Signature: (pes (N,) f32, definite (N,) bool, base_ids (N,) int32)
      → () int32 row id of the global k-th best definite pessimistic score.
    """

    def local(pes, definite, base_ids):
        masked = torch.where(definite, pes,
                             torch.full_like(pes, float("-inf")))
        vals, idx = _top(masked, min(k, masked.shape[0]))
        return vals, base_ids[idx]

    mapped = shard_map(mesh, local, (ROW, ROW, ROW), (ROW, ROW))

    def step(pes, definite, base_ids):
        g_vals, g_ids = mapped(pes, definite, base_ids)
        order = _top(g_vals, k)[1]
        return g_ids[order[k - 1]]

    return step


def make_mask_agg_step(mesh: Mesh):
    """Fused thresholded intersection/union *counts* for MASK_AGG group
    verification, group rows sharded over all devices (the counts-level
    sibling of ``iou_agg_step``; the ``mask_agg_counts`` kernel on each
    shard).

    Signature: (group_masks (G,S,H,W), rois (G,4), thresh ())
      → (inter (G,), union (G,)) int32.
    """
    return shard_map(mesh, kops.mask_agg_counts, (ROW, ROW, REP),
                     (ROW, ROW))


def make_cp_multi_step(mesh: Mesh):
    """Fused multi-descriptor CP over one sharded mask batch — the service
    scheduler's cross-query verification pass on the mesh (Q descriptors
    answered from one pass over the sharded bytes).

    Signature: (masks (B,H,W), rois (Q,B,4), lvs (Q,), uvs (Q,))
      → counts (Q,B) int32.
    """
    return shard_map(mesh, kops.cp_count_multi, (ROW, COL, REP, REP),
                     COL)


def make_pair_counts_step(mesh: Mesh):
    """Fused dual-mask pair counts, pair rows sharded over all devices —
    the mesh backend's verification pass for the discrepancy (pair) query
    class (DESIGN.md §9).  The i-th rows of ``masks_a`` and ``masks_b``
    are one image's role pair and shard to the same device, so the kernel
    runs collective-free (``pair_counts`` on each shard).

    Signature: (masks_a (B,H,W), masks_b (B,H,W), rois (B,4), ta (), tb ())
      → (inter (B,), union (B,), diff (B,)) int32.
    """
    return shard_map(mesh, kops.pair_counts,
                     (ROW, ROW, ROW, REP, REP), (ROW, ROW, ROW))


def pair_cells(stat: str, tables_a, tables_b, ks, rois, row_bounds,
               col_bounds):
    """Sound (lb, ub) of one pair stat from both roles' CHI rows: the
    per-cell thresholded counts at ``ks`` = [ka_in, ka_out, kb_in, kb_out]
    and the cell algebra, on the rows' device."""
    ks = _ints(ks)
    dev = tables_a.device
    return pair_cell_bounds_torch(
        stat, cell_counts_torch(tables_a, ks[0]),
        cell_counts_torch(tables_a, ks[1]),
        cell_counts_torch(tables_b, ks[2]),
        cell_counts_torch(tables_b, ks[3]), rois,
        _bounds_on(row_bounds, dev), _bounds_on(col_bounds, dev))


def make_pair_cells_step(mesh: Mesh, stat: str):
    """The pair-term *bounds* pass on the mesh (DESIGN.md §13): the
    cell-decomposed sound combination of both roles' CHI rows
    (:func:`pair_cells`), pair rows sharded over all devices.
    Collective-free — each pair's cell math reads only its own two CHI
    rows — so, like the CP-leaf bounds step, the pair filter phase leaves
    the host entirely.  Padded rows (zero tables + zero ROIs) yield
    lb = ub = 0 and are sliced off by the caller.

    Signature: (tables_a (B,G+1,G+1,NB+1), tables_b (B,G+1,G+1,NB+1),
                rois (B,4), ks (4,) int32 [ka_in, ka_out, kb_in, kb_out],
                row_bounds (G+1,), col_bounds (G+1,))
      → (lb (B,), ub (B,)) float64 of integer values.
    """

    def local(tables_a, tables_b, rois, ks, row_bounds, col_bounds):
        return pair_cells(stat, tables_a, tables_b, ks, rois, row_bounds,
                          col_bounds)

    return shard_map(mesh, local, (ROW, ROW, ROW, REP, REP, REP),
                     (ROW, ROW))


# -- bitpacked binary-mask tier (DESIGN.md §12) -----------------------------
# Packed variants of the verification steps: identical shardings (the word
# axis replaces the pixel-column axis, rank for rank), kernel dispatch
# swapped for the popcount family.  Pair/agg thresholds are float32 — the
# packed wrappers derive integer flags from them; the words (int32 bit
# views of the store's uint32 words) never meet a float lane.


def make_verify_packed_step(mesh: Mesh):
    """``make_verify_step`` over packed words.

    Signature: (packed (V,H,words), rois (V,4), lv (), uv ())
      → counts (V,) int32.
    """
    return shard_map(mesh, kops.cp_count_packed,
                     (ROW, ROW, REP, REP), ROW)


def make_cp_multi_packed_step(mesh: Mesh):
    """``make_cp_multi_step`` over packed words.

    Signature: (packed (B,H,words), rois (Q,B,4), lvs (Q,), uvs (Q,))
      → counts (Q,B) int32.
    """
    return shard_map(mesh, kops.cp_count_multi_packed,
                     (ROW, COL, REP, REP), COL)


def make_mask_agg_packed_step(mesh: Mesh):
    """``make_mask_agg_step`` over packed words.

    Signature: (group_packed (G,S,H,words), rois (G,4), thresh () f32)
      → (inter (G,), union (G,)) int32.
    """
    return shard_map(mesh, kops.mask_agg_counts_packed,
                     (ROW, ROW, REP), (ROW, ROW))


def make_pair_counts_packed_step(mesh: Mesh):
    """``make_pair_counts_step`` over packed words.

    Signature: (packed_a (B,H,words), packed_b (B,H,words), rois (B,4),
                ta () f32, tb () f32)
      → (inter (B,), union (B,), diff (B,)) int32.
    """
    return shard_map(mesh, kops.pair_counts_packed,
                     (ROW, ROW, ROW, REP, REP), (ROW, ROW, ROW))


def make_fused_verify_step(mesh: Mesh):
    """The bounds+verify megakernel on the mesh: batch rows shard over all
    devices, the Q descriptor axis (rois/decided/lb) shards with them on
    the batch dimension, and every shard answers its rows collective-free
    in one launch.

    Signature: (packed (B,H,words), rois (Q,B,4), lvs (Q,), uvs (Q,),
                decided (Q,B) int32, lb (Q,B) int32)
      → counts (Q,B) int32.
    """
    return shard_map(mesh, kops.fused_bounds_verify,
                     (ROW, COL, REP, REP, COL, COL), COL)


def make_iou_agg_step(mesh: Mesh):
    """Fused group IoU: masks (Ngroups, n_types, H, W) → IoU scores, from
    the ``mask_agg_counts`` kernel's counts on each shard: float32
    ``inter / max(union, 1)``, 0 where the union is empty.

    Signature: (group_masks, rois (Ngroups,4), thresh ()) → iou (Ngroups,) f32.
    """

    def local(group_masks, rois, thresh):
        inter, union = kops.mask_agg_counts(group_masks, rois, thresh)
        inter, union = inter.to(torch.float32), union.to(torch.float32)
        return torch.where(union > 0, inter / union.clamp(min=1),
                           torch.zeros_like(inter))

    return shard_map(mesh, local, (ROW, ROW, REP), ROW)


# ---------------------------------------------------------------------------
# Host-side orchestration of the steps for a sharded DB
# ---------------------------------------------------------------------------


class DistributedEngine:
    """Thin host orchestrator over the step functions for a sharded DB."""

    def __init__(self, mesh: Mesh, cfg: chi_lib.CHIConfig):
        self.mesh = mesh
        self.cfg = cfg
        self._filter_steps: dict[str, object] = {}
        self._verify = make_verify_step(mesh)
        self._topk_steps: dict[tuple, object] = {}
        self._rb = np.asarray(cfg.row_bounds, np.int32)
        self._cb = np.asarray(cfg.col_bounds, np.int32)

    def _value_ks(self, lv: float, uv: float) -> np.ndarray:
        return value_ks(self.cfg, lv, uv)

    def filter_bounds(self, tables, rois, lv, uv, op, threshold):
        if op not in self._filter_steps:
            self._filter_steps[op] = make_filter_bounds_step(self.mesh, op)
        return self._filter_steps[op](
            tables, _int32(rois), self._rb, self._cb,
            self._value_ks(lv, uv), np.asarray(threshold, np.int32))

    def verify(self, masks, rois, lv, uv):
        return self._verify(masks, _int32(rois), np.float32(lv),
                            np.float32(uv))

    def topk_candidates(self, tables, rois, lv, uv, k, desc=True, ids=None):
        key = (k, desc)
        if key not in self._topk_steps:
            self._topk_steps[key] = make_topk_step(self.mesh, k, desc)[0]
        if ids is None:
            ids = np.arange(tables.shape[0], dtype=np.int32)
        return self._topk_steps[key](
            tables, _int32(rois), self._rb, self._cb,
            self._value_ks(lv, uv), ids)


def _int32(x):
    """ROIs as int32, numpy or placed as they are."""
    if isinstance(x, (Sharded, torch.Tensor)):
        return x
    return np.asarray(x, np.int32)
