"""CUDA dual-mask pair kernel (``csrc/pair_count.cu``) behind ctypes.

:func:`pair_counts_cuda` launches ``pair_count_kern``, the port of the
Pallas ``_pair_kernel``: for each (A, B) mask pair, the counts of A∩B, A∪B
and A∖B inside the pair's ROI, with A = ``masks_a > ta`` and
B = ``masks_b > tb`` — every pair statistic the plan IR can express comes
from these three, in one pass over both masks.  The thresholds are rounded
to the mask dtype first, as the Pallas wrapper casts them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("pair_count")
    cuda_lib.bind(lib.pair_count_launch,
                  [_P, _P, _I, _P, _F, _F, _I, _I, _I, _I, _P, _P])
    return lib


def pair_counts_cuda(masks_a: torch.Tensor, masks_b: torch.Tensor, rois,
                     ta, tb):
    """(B, H, W) x 2 f32/bf16, (B, 4), ta, tb → ((inter, union, diff) each
    (B,) int32, launches)."""
    cuda_lib.require_cuda(masks_a, "masks_a", cuda_lib.DTYPE_CODES)
    cuda_lib.require_cuda(masks_b, "masks_b", (masks_a.dtype,))
    if masks_b.shape != masks_a.shape:
        raise ValueError(f"masks_b shape {tuple(masks_b.shape)} differs from "
                         f"masks_a {tuple(masks_a.shape)}")
    b, h, w = masks_a.shape
    dev = masks_a.device
    rois = cuda_lib.int32_rows(rois, dev, (b, 4))
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    if b == 0:
        return tuple(out), 0
    dt = masks_a.dtype
    vec = cuda_lib.vec_ok(masks_a, w) & cuda_lib.vec_ok(masks_b, w)
    rc = _lib().pair_count_launch(
        masks_a.data_ptr(), masks_b.data_ptr(), cuda_lib.DTYPE_CODES[dt],
        rois.data_ptr(), cuda_lib.in_dtype(ta, dt), cuda_lib.in_dtype(tb, dt),
        b, h, w, vec, out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "pair_counts")
    return tuple(out), 1
