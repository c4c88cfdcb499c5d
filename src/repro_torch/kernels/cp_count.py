"""CUDA CP verification kernels (``csrc/cp_count.cu``) behind ctypes.

The engine's verification hot path: for every surviving mask, count the
pixels whose value lies in ``[lv, uv)`` inside the mask's ROI.
:func:`cp_count_cuda` launches ``cp_count_kern`` (the port of the Pallas
``_cp_kernel``); :func:`cp_count_multi_cuda` launches
``cp_count_multi_kern`` (the port of ``_cp_multi_kernel``), which answers
Q descriptors from one read of each mask — optionally the rows at
``positions`` of the resident array, read in place.  Both return
``(out, launches)`` so the dispatching wrapper in :mod:`.ops` counts only
real launches.

Thresholds are rounded to the mask dtype here, before the kernel sees
them, exactly as the Pallas wrappers cast lv/uv to ``masks.dtype`` — on
the host, so they cost the device one pinned copy and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# Elements of one block's row strip in the single-descriptor kernel: ~8
# sixteen-byte loads per thread.
_STRIP_VECS = 2048


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("cp_count")
    cuda_lib.bind(lib.cp_count_launch,
                  [_P, _I, _P, _F, _F, _I, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.cp_count_multi_launch,
                  [_P, _I, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P])
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


def _host(x) -> torch.Tensor:
    t = torch.as_tensor(x)
    return t.cpu() if t.device.type != "cpu" else t


def thresholds(lvs, uvs, dtype) -> torch.Tensor:
    """(Q, 2) f32 host tensor of (lv, uv), each rounded to the mask dtype
    exactly as the plain version rounds them (the exact f32 values the
    kernel compares against).  Host arrays cost no device work; a CUDA
    tensor is read back first."""
    lvs = _host(lvs).reshape(-1)
    uvs = _host(uvs).reshape(-1)
    if lvs.shape != uvs.shape:
        raise ValueError("lvs and uvs must have the same length")
    return torch.stack([lvs.to(dtype).float(), uvs.to(dtype).float()], 1)


def cp_count_multi_cuda(masks: torch.Tensor, rois, lvs, uvs, positions=None):
    """(N, H, W), (Q, B, 4), (Q,), (Q,), positions (B,) int64 or None →
    ((Q, B) int32, launches).  Mask ``b`` is ``masks[positions[b]]``, read
    in place (no gather), or ``masks[b]`` without positions; positions must
    lie in [0, N) (the kernel traps otherwise, as an index out of range
    does)."""
    cuda_lib.require_cuda(masks, "masks", cuda_lib.DTYPE_CODES)
    n, h, w = masks.shape
    dev = masks.device
    thr = thresholds(lvs, uvs, masks.dtype)
    q = thr.shape[0]
    if positions is None:
        b, pos_ptr = n, None
    else:
        positions = torch.as_tensor(positions).to(dev, torch.int64)
        positions = positions.reshape(-1).contiguous()
        b, pos_ptr = positions.shape[0], positions.data_ptr()
    rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
    if q == 0 or b == 0 or h == 0 or w == 0:
        return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
    out = torch.empty((q, b), dtype=torch.int32, device=dev)
    # one pinned, non-blocking copy: a copy from pageable memory would wait
    # for every launch queued before it
    thr = thr.pin_memory().to(dev, non_blocking=True)
    rc = _lib().cp_count_multi_launch(
        masks.data_ptr(), cuda_lib.DTYPE_CODES[masks.dtype], pos_ptr, n,
        rois.data_ptr(), thr.data_ptr(), q, b, h, w,
        cuda_lib.vec_ok(masks, w), out.data_ptr(),
        cuda_lib.stream(dev))
    cuda_lib.check(rc, "cp_count_multi")
    return out, 1
