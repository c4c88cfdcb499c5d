"""Bitpacked binary-mask representation (1 bit/pixel, uint32 words).

Binary mask types (segmentation outputs, thresholded detections) carry one
bit of information per pixel but the float tier moves them as float32 —
32× the bytes on a bandwidth-bound query class.  A *packed* store keeps
each mask row as ``ceil(W / 32)`` little-endian uint32 words: bit ``i`` of
word ``k`` is pixel column ``k * 32 + i``.  Tail bits past ``W`` in the
last word are always zero — an invariant established here at pack time and
relied on by every popcount kernel (kernels/popcount.py), which therefore
never needs the width: ROI column spans are clipped to ``W`` upstream
(``cp.normalize_rois``) and the stored words carry no garbage past it.

Packing is lossless only for binary inputs, so ingest validates values are
exactly {0.0, 1.0}; CP semantics on the packed tier reduce to an exact
integer decomposition (see kernels/popcount.py) that is bit-identical to
the float kernels on the same data.

On torch the words travel as an ``int32`` bit view (:func:`torch_bits`):
torch's ``uint32`` has no shifts, no ``~`` and no ``index_copy_`` on the
CPU, and no broader support on CUDA.  Every numpy surface (``load``,
``resident_masks``, I/O metering) stays ``uint32``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["words_for", "packed_row_nbytes", "validate_binary",
           "pack_masks", "unpack_masks", "torch_bits"]

WORD_BITS = 32


def words_for(width: int) -> int:
    """uint32 words per mask row of ``width`` pixel columns."""
    return (int(width) + WORD_BITS - 1) // WORD_BITS


def packed_row_nbytes(height: int, width: int) -> int:
    """Bytes of one packed mask: ``H × ceil(W/32)`` uint32 words."""
    return int(height) * words_for(width) * 4


def validate_binary(masks: np.ndarray) -> None:
    """Raise ValueError unless every value is exactly 0.0 or 1.0."""
    arr = np.asarray(masks)
    if arr.size and not np.logical_or(arr == 0, arr == 1).all():
        bad = arr[np.logical_and(arr != 0, arr != 1)].flat[0]
        raise ValueError(
            f"packed stores hold binary masks only: found value {bad!r} "
            f"outside {{0, 1}} — threshold the masks before ingest")


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """``(..., W)`` binary → ``(..., words)`` uint32, LSB-first.

    Nonzero pixels become set bits; tail bits beyond ``W`` in the last
    word are zero.  Works on any leading shape (whole batches, row spans).
    """
    arr = np.asarray(masks)
    w = arr.shape[-1]
    words = words_for(w)
    bits = arr != 0
    pad = words * WORD_BITS - w
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bool)], axis=-1)
    packed = np.packbits(bits, axis=-1, bitorder="little")
    packed = np.ascontiguousarray(packed).view("<u4")
    return packed.astype(np.uint32, copy=False)


def torch_bits(arr: np.ndarray) -> np.ndarray:
    """The host array to hand to ``torch.from_numpy``: packed ``uint32``
    words as their ``int32`` bit view (same bytes, no copy), anything else
    as it is."""
    arr = np.ascontiguousarray(arr)
    return arr.view(np.int32) if arr.dtype == np.uint32 else arr


def unpack_masks(packed: np.ndarray, width: int,
                 dtype=np.float32) -> np.ndarray:
    """``(..., words)`` uint32 → ``(..., width)`` of ``dtype`` in {0, 1}."""
    arr = np.ascontiguousarray(np.asarray(packed), dtype="<u4")
    bits = np.unpackbits(arr.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :int(width)].astype(dtype)
