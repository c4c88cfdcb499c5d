"""CUDA MASK_AGG kernel (``csrc/mask_agg.cu``) behind ctypes.

:func:`mask_agg_counts_cuda` launches ``mask_agg_kern``, the port of the
Pallas ``_agg_kernel``: for each group of S member masks, the counts of
pixels inside the group's ROI where all members (intersection) and any
member (union) exceed the threshold — the fused primitive behind
Scenario-3 IoU queries.  The threshold is rounded to the mask dtype first,
as the Pallas wrapper casts it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIP_VECS = 2048


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("mask_agg")
    cuda_lib.bind(lib.mask_agg_launch,
                  [_P, _I, _P, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    return lib


def mask_agg_counts_cuda(group_masks: torch.Tensor, rois, thresh):
    """(N, S, H, W), (N, 4), scalar → ((inter (N,), union (N,)), launches)."""
    cuda_lib.require_cuda(group_masks, "group_masks", cuda_lib.DTYPE_CODES)
    n, s, h, w = group_masks.shape
    dev = group_masks.device
    rois = cuda_lib.int32_rows(rois, dev, (n, 4))
    inter = torch.zeros(n, dtype=torch.int32, device=dev)
    union = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0 or h == 0 or w == 0:
        return (inter, union), 0
    strip = max(1, min(h, _STRIP_VECS * cuda_lib.VEC[group_masks.dtype] // w))
    rc = _lib().mask_agg_launch(
        group_masks.data_ptr(), cuda_lib.DTYPE_CODES[group_masks.dtype],
        rois.data_ptr(), cuda_lib.in_dtype(thresh, group_masks.dtype),
        n, s, h, w, strip, cuda_lib.vec_ok(group_masks, w), inter.data_ptr(),
        union.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "mask_agg_counts")
    return (inter, union), 1
