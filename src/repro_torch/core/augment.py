"""Scenario-1 dataset augmentation (demo §4, Step 3).

The port of the JAX package's ``core/augment.py``.  After a Top-K/Filter
query retrieves images where the model attends outside the object
bounding box, the demo's "Start Augment" button randomizes pixels
*outside* the ROI (keeping labels) so the retrained model cannot rely on
background correlations.  This is that button, as a library call wired
into the data pipeline.

Randomness comes from an explicit ``torch.Generator`` on the tensor's
device (the reference takes a JAX PRNG key), so the noise differs from
the reference's; what is kept is where it goes.
"""

from __future__ import annotations

import torch

from ..kernels.ref import _roi_mask


def randomize_outside_roi(generator: torch.Generator, images: torch.Tensor,
                          rois) -> torch.Tensor:
    """Replace pixels outside each image's ROI with uniform noise.

    Args:
      generator: a generator on ``images``' device.
      images: (B, H, W) or (B, H, W, C) floats in [0, 1].
      rois: (B, 4) half-open rectangles (the object boxes).
    Returns:
      Augmented images, same shape/dtype.
    """
    h, w = images.shape[1:3]
    inside = _roi_mask(torch.as_tensor(rois, device=images.device), h, w)
    if images.ndim == 4:
        inside = inside[..., None]
    noise = torch.rand(images.shape, generator=generator,
                       dtype=images.dtype, device=images.device)
    return torch.where(inside, images, noise)


def mix_augmented(generator: torch.Generator, tokens: torch.Tensor,
                  selected: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """LM analogue: re-randomize the selected sequences (selected: (B,)
    bool; their tokens are replaced by fresh random ids in
    [0, vocab_size)).  Used when the "images" are token grids."""
    noise = torch.randint(0, vocab_size, tokens.shape, generator=generator,
                          dtype=tokens.dtype, device=tokens.device)
    return torch.where(selected.to(tokens.device)[:, None], noise, tokens)
