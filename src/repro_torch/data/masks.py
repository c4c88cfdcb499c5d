"""Synthetic saliency-mask generator for benchmarks/examples.

Real model-saliency maps (the paper's iWildCam Grad-CAM masks) are smooth,
blobby, spatially coherent fields — which is exactly why CHI prunes well on
them (a mask that is hot in one region is provably cold elsewhere).  This
generator reproduces those statistics: a few Gaussian bumps (the "object"
focus) over a low-level smooth background, normalized to [0, 1).

``attacked=True`` masks get extra diffuse mid-value noise — the Scenario-2
adversarial signature (dispersed attention) that CP(·, full, (0.2, 0.6))
queries single out.
"""

from __future__ import annotations

import numpy as np


def saliency_masks(n: int, height: int = 128, width: int = 128, *,
                   seed: int = 0, n_blobs=(1, 4),
                   attacked_fraction: float = 0.0,
                   boxes: np.ndarray | None = None,
                   in_box_fraction: float = 0.9
                   ) -> tuple[np.ndarray, np.ndarray]:
    """→ (masks (n, H, W) float32 in [0,1), attacked (n,) bool).

    With ``boxes`` given (the per-image object boxes), the dominant blob is
    centered *inside* the box for ``in_box_fraction`` of masks — a model
    that mostly attends to the object, with a minority of
    spurious-correlation cases attending to background.  That is the
    distribution the paper's Scenario-1 queries hunt through, and what
    gives the filter-verification framework its pruning power.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    masks = np.empty((n, height, width), np.float32)
    attacked = rng.random(n) < attacked_fraction
    for i in range(n):
        k = rng.integers(n_blobs[0], n_blobs[1] + 1)
        field = rng.uniform(0.0, 0.15) * np.ones((height, width), np.float32)
        in_box = boxes is not None and rng.random() < in_box_fraction
        for j in range(k):
            if in_box and j == 0:        # dominant blob inside the object box
                r0, c0, r1, c1 = boxes[i]
                cy = rng.uniform(r0 + 0.25 * (r1 - r0), r1 - 0.25 * (r1 - r0))
                cx = rng.uniform(c0 + 0.25 * (c1 - c0), c1 - 0.25 * (c1 - c0))
                sy = rng.uniform(0.15, 0.35) * (r1 - r0)
                sx = rng.uniform(0.15, 0.35) * (c1 - c0)
                amp = rng.uniform(0.9, 1.2)
            else:
                cy = rng.uniform(0.15, 0.85) * height
                cx = rng.uniform(0.15, 0.85) * width
                sy = rng.uniform(0.05, 0.25) * height
                sx = rng.uniform(0.05, 0.25) * width
                amp = rng.uniform(0.3, 0.7) if in_box else rng.uniform(0.5, 1.0)
            field += amp * np.exp(-(((yy - cy) / sy) ** 2 +
                                    ((xx - cx) / sx) ** 2))
        if attacked[i]:
            # diffuse mid-value noise over the whole image (S2 signature)
            field = 0.45 * field + rng.uniform(0.25, 0.5) * \
                np.abs(np.sin(yy / rng.uniform(3, 9)) *
                       np.cos(xx / rng.uniform(3, 9)))
        lo, hi = field.min(), field.max()
        masks[i] = (field - lo) / max(hi - lo, 1e-9) * (1.0 - 1e-6)
    return masks, attacked


def object_boxes(n: int, height: int, width: int, *, seed: int = 1) -> np.ndarray:
    """Random object bounding boxes (the YOLO-box stand-in), (n, 4) int32."""
    rng = np.random.default_rng(seed)
    h = rng.integers(height // 4, height // 2, n)
    w = rng.integers(width // 4, width // 2, n)
    r0 = rng.integers(0, height - h, n)
    c0 = rng.integers(0, width - w, n)
    return np.stack([r0, c0, r0 + h, c0 + w], axis=1).astype(np.int32)
