"""CUDA CP verification kernels (``csrc/cp_count.cu``) behind ctypes.

The engine's verification hot path: for every surviving mask, count the
pixels whose value lies in ``[lv, uv)`` inside the mask's ROI.
:func:`cp_count_cuda` launches ``cp_count_kern`` (the port of the Pallas
``_cp_kernel``); :func:`cp_count_multi_cuda` launches
``cp_count_multi_kern`` (the port of ``_cp_multi_kernel``), which answers
Q descriptors from one read of each mask.  Both return ``(out, launches)``
so the dispatching wrapper in :mod:`.ops` counts only real launches.

Thresholds are rounded to the mask dtype here, before the kernel sees
them, exactly as the Pallas wrappers cast lv/uv to ``masks.dtype``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Elements of one block's row strip: ~8 sixteen-byte loads per thread for
# the streaming kernel, and a <= 32 KiB f32 shared tile for the multi one.
_STRIP_VECS = 2048
_TILE_FLOATS = 8192
_MAX_SMEM_FLOATS = 12288          # 48 KiB of default dynamic shared memory


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("cp_count")
    cuda_lib.bind(lib.cp_count_launch,
                  [_P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.cp_count_multi_launch,
                  [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P])
    return lib


def cp_count_cuda(masks: torch.Tensor, rois, lv, uv):
    """(B, H, W) f32/bf16, (B, 4) → ((B,) int32, launches)."""
    cuda_lib.require_cuda(masks, "masks", cuda_lib.DTYPE_CODES)
    b, h, w = masks.shape
    dev = masks.device
    rois = cuda_lib.int32_rows(rois, dev, (b, 4))
    out = torch.zeros(b, dtype=torch.int32, device=dev)
    if b == 0 or h == 0 or w == 0:
        return out, 0
    strip = max(1, min(h, _STRIP_VECS * cuda_lib.VEC[masks.dtype] // w))
    rc = _lib().cp_count_launch(
        masks.data_ptr(), cuda_lib.DTYPE_CODES[masks.dtype], rois.data_ptr(),
        cuda_lib.in_dtype(lv, masks.dtype), cuda_lib.in_dtype(uv, masks.dtype),
        b, h, w, strip, cuda_lib.vec_ok(masks, w), out.data_ptr(),
        cuda_lib.stream(dev))
    cuda_lib.check(rc, "cp_count")
    return out, 1


def cp_count_multi_cuda(masks: torch.Tensor, rois, lvs, uvs):
    """(B, H, W), (Q, B, 4), (Q,), (Q,) → ((Q, B) int32, launches)."""
    cuda_lib.require_cuda(masks, "masks", cuda_lib.DTYPE_CODES)
    b, h, w = masks.shape
    dev = masks.device
    lvs = torch.as_tensor(lvs).reshape(-1)
    q = lvs.shape[0]
    rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
    # thresholds in the mask dtype, carried as their exact f32 values
    lvs = lvs.to(dev).to(masks.dtype).float().contiguous()
    uvs = torch.as_tensor(uvs).reshape(-1).to(dev).to(masks.dtype).float()
    uvs = uvs.contiguous()
    if uvs.shape[0] != q:
        raise ValueError("lvs and uvs must have the same length")
    out = torch.zeros((q, b), dtype=torch.int32, device=dev)
    if q == 0 or b == 0 or h == 0 or w == 0:
        return out, 0
    if w > _MAX_SMEM_FLOATS:
        raise ValueError(f"cp_count_multi takes rows of at most "
                         f"{_MAX_SMEM_FLOATS} pixels, got {w}")
    strip = max(1, min(h, _TILE_FLOATS // w))
    rc = _lib().cp_count_multi_launch(
        masks.data_ptr(), cuda_lib.DTYPE_CODES[masks.dtype], rois.data_ptr(),
        lvs.data_ptr(), uvs.data_ptr(), q, b, h, w, strip,
        cuda_lib.vec_ok(masks, w), out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "cp_count_multi")
    return out, 1
