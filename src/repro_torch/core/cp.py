"""CP — the paper's "Count Pixels" function.

``CP(mask, roi, (lv, uv))`` counts pixels of ``mask`` inside the rectangular
region-of-interest ``roi`` whose value falls in the half-open range
``[lv, uv)``.  This module holds the *exact* (non-indexed) implementations:

* :func:`cp_exact` — batched torch implementation (the full-scan baseline),
  a thin call into the kernels' plain versions in :mod:`..kernels.ref`.
* :func:`cp_exact_np` — numpy oracle used by tests and the disk-tier scan.

ROI convention (used everywhere in this codebase):
    ``roi = (r0, c0, r1, c1)`` — half-open pixel rectangle
    ``rows r0 <= r < r1``, ``cols c0 <= c < c1``.
A ``None`` ROI means the full mask (the paper's ``full_img``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ref


def full_roi(height: int, width: int) -> np.ndarray:
    """The ROI covering the whole mask (paper's ``full_img``)."""
    return np.array([0, 0, height, width], dtype=np.int32)


def normalize_rois(rois, batch: int, height: int, width: int) -> np.ndarray:
    """Broadcast/validate ROIs to an ``(B, 4)`` int32 array, clipped to bounds."""
    if rois is None:
        rois = np.tile(full_roi(height, width), (batch, 1))
    rois = np.asarray(rois, dtype=np.int32)
    if rois.ndim == 1:
        rois = np.tile(rois[None, :], (batch, 1))
    if rois.shape != (batch, 4):
        raise ValueError(f"rois must have shape ({batch}, 4), got {rois.shape}")
    out = rois.copy()
    out[:, 0] = np.clip(rois[:, 0], 0, height)
    out[:, 1] = np.clip(rois[:, 1], 0, width)
    out[:, 2] = np.clip(rois[:, 2], 0, height)
    out[:, 3] = np.clip(rois[:, 3], 0, width)
    return out


def roi_area(rois: np.ndarray) -> np.ndarray:
    """Pixel area of each half-open ROI rectangle; shape ``(B,)``."""
    rois = np.asarray(rois)
    h = np.maximum(rois[..., 2] - rois[..., 0], 0)
    w = np.maximum(rois[..., 3] - rois[..., 1], 0)
    return (h * w).astype(np.int64)


def _per_mask(x) -> torch.Tensor:
    """A scalar or per-mask ``(B,)`` threshold, broadcastable over masks."""
    t = torch.as_tensor(x, dtype=torch.float64)
    return t.view(-1, 1, 1) if t.ndim == 1 else t


def cp_exact(masks: torch.Tensor, rois, lv, uv) -> torch.Tensor:
    """Exact CP for a batch.

    Args:
      masks: ``(B, H, W)`` float tensor, values in ``[0, 1)``.
      rois:  ``(B, 4)`` int32 half-open rectangles.
      lv/uv: scalars (or ``(B,)``) — half-open value range ``[lv, uv)``.

    Returns:
      ``(B,)`` int32 pixel counts.
    """
    return ref.cp_count_ref(masks, rois, _per_mask(lv), _per_mask(uv))


def cp_exact_np(mask: np.ndarray, roi, lv: float, uv: float) -> int:
    """Pure-numpy oracle for a single mask (used by tests + disk full-scan)."""
    h, w = mask.shape
    if roi is None:
        roi = (0, 0, h, w)
    r0, c0, r1, c1 = (int(x) for x in roi)
    r0, r1 = max(r0, 0), min(r1, h)
    c0, c1 = max(c0, 0), min(c1, w)
    if r1 <= r0 or c1 <= c0:
        return 0
    window = mask[r0:r1, c0:c1]
    return int(np.count_nonzero((window >= lv) & (window < uv)))


def cp_exact_multi(masks: torch.Tensor, rois, lvs, uvs) -> torch.Tensor:
    """Exact CP for B masks × Q (roi, range) descriptors.

    Args:
      masks: ``(B, H, W)``.
      rois:  ``(Q, B, 4)`` or ``(Q, 4)`` (broadcast over masks).
      lvs/uvs: ``(Q,)``.

    Returns:
      ``(Q, B)`` int32 — one CP table per descriptor.
    """
    rois = torch.as_tensor(rois).to(device=masks.device, dtype=torch.int32)
    if rois.ndim == 2:
        rois = rois[:, None, :].expand(rois.shape[0], masks.shape[0], 4)
    return ref.cp_count_multi_ref(masks, rois, lvs, uvs)
