"""Plain PyTorch versions of every CUDA kernel in this package.

These are the semantics; the kernels are the fast implementations.  The
wrappers in :mod:`.ops` run them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds each kernel against them on the card.  Every
output is an exact int32 count, so agreement means equality.

Thresholds compare in the mask dtype: a Python float is rounded to it
first, as the JAX references' weakly typed scalars and the Pallas
wrappers' casts do.
"""

from __future__ import annotations

import torch


def _roi_mask(rois: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W) bool — True inside each half-open ROI rectangle."""
    dev = rois.device
    rr = torch.arange(height, device=dev).view(1, height, 1)
    cc = torch.arange(width, device=dev).view(1, 1, width)
    r0, c0, r1, c1 = (rois[:, i].view(-1, 1, 1) for i in range(4))
    return (rr >= r0) & (rr < r1) & (cc >= c0) & (cc < c1)


def _as_dtype(x, t: torch.Tensor) -> torch.Tensor:
    """A scalar threshold (or a (Q,) vector) in ``t``'s dtype and device."""
    return torch.as_tensor(x, dtype=torch.float64).to(t.device).to(t.dtype)


def _rois(rois, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rois).to(device=t.device, dtype=torch.int32)


def cp_count_ref(masks: torch.Tensor, rois, lv, uv) -> torch.Tensor:
    """(B, H, W), (B, 4), scalars → (B,) int32 — exact CP."""
    _, h, w = masks.shape
    inside = _roi_mask(_rois(rois, masks), h, w)
    in_range = (masks >= _as_dtype(lv, masks)) & (masks < _as_dtype(uv, masks))
    return (inside & in_range).sum(dim=(1, 2), dtype=torch.int32)


def cp_count_multi_ref(masks: torch.Tensor, rois, lvs, uvs) -> torch.Tensor:
    """(B, H, W), (Q, B, 4), (Q,), (Q,) → (Q, B) int32 — the multi-query
    CP pass (one read of the mask bytes answers Q descriptors)."""
    rois = _rois(rois, masks)
    lvs = torch.as_tensor(lvs).reshape(-1)
    uvs = torch.as_tensor(uvs).reshape(-1)
    lvs = lvs.to(masks.device).to(masks.dtype)
    uvs = uvs.to(masks.device).to(masks.dtype)
    rows = [cp_count_ref(masks, rois[q], lvs[q], uvs[q])
            for q in range(lvs.shape[0])]
    if not rows:
        return torch.zeros((0, masks.shape[0]), dtype=torch.int32,
                           device=masks.device)
    return torch.stack(rows)


def _cell_of(n: int, grid: int, device) -> torch.Tensor:
    """Cell index of each of ``n`` pixel rows/cols for boundaries
    ``(i * n) // grid`` — ``searchsorted(bounds, p, right) - 1`` clipped,
    as ``build_chi_np`` computes it (ragged grids included)."""
    bounds = torch.arange(grid + 1, dtype=torch.int64) * n // grid
    cell = torch.searchsorted(bounds, torch.arange(n), right=True) - 1
    return cell.clamp(0, grid - 1).to(device)


def chi_cell_hist_ref(masks: torch.Tensor, interior_edges,
                      grid: int) -> torch.Tensor:
    """(B, H, W), interior edges (NB-1,) → (B, G, G, NB) int32 per-cell,
    per-bin pixel counts.  A pixel's bin is the number of interior edges
    <= its value, compared in the mask dtype."""
    b, h, w = masks.shape
    g = int(grid)
    edges = _as_dtype(interior_edges, masks).reshape(-1).contiguous()
    nb = edges.shape[0] + 1
    bins = torch.zeros(masks.shape, dtype=torch.int64, device=masks.device)
    for e in edges:
        bins += masks >= e
    cell = (_cell_of(h, g, masks.device)[:, None] * g +
            _cell_of(w, g, masks.device)[None, :])
    key = (cell[None] * nb + bins).reshape(b, -1)
    counts = torch.zeros((b, g * g * nb), dtype=torch.int32,
                         device=masks.device)
    counts.scatter_add_(1, key, torch.ones_like(key, dtype=torch.int32))
    return counts.reshape(b, g, g, nb)


def mask_agg_counts_ref(group_masks: torch.Tensor, rois, thresh):
    """(N, S, H, W), (N, 4), scalar → (inter (N,), union (N,)) int32:
    counts of the thresholded intersection / union inside each ROI."""
    _, _, h, w = group_masks.shape
    binary = group_masks > _as_dtype(thresh, group_masks)
    inter = binary.all(dim=1)
    union = binary.any(dim=1)
    inside = _roi_mask(_rois(rois, group_masks), h, w)
    return ((inter & inside).sum(dim=(1, 2), dtype=torch.int32),
            (union & inside).sum(dim=(1, 2), dtype=torch.int32))
