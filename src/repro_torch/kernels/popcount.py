"""CUDA popcount kernels over packed binary masks (``csrc/popcount.cu``)
behind ctypes.

The packed tier's verification hot path.  Masks are ``(…, H, words)``
int32 tensors, the bit view of the store's uint32 words.  Five launchers,
each the port of a Pallas kernel in the JAX package's ``popcount.py``:

* :func:`cp_count_packed_cuda` — ``cp_packed_kern`` (``_cp_popcount_kernel``):
  exact CP per mask;
* :func:`cp_count_multi_packed_cuda` — ``cp_multi_packed_kern``
  (``_cp_multi_popcount_kernel``): Q descriptors from one read of each mask;
* :func:`fused_bounds_verify_cuda` — ``fused_verify_kern``
  (``_fused_verify_popcount_kernel``): Q descriptors, CHI-decided entries
  passed through uncounted — one launch per verification batch;
* :func:`mask_agg_counts_packed_cuda` — ``agg_packed_kern``
  (``_agg_popcount_kernel``): AND / OR over S members;
* :func:`pair_counts_packed_cuda` — ``pair_packed_kern``
  (``_pair_popcount_kernel``): inter / union / diff of two masks per pair.

The CP range and the threshold reach the kernels as integer flags,
computed here from float32 values exactly as the JAX wrappers do
(``ref._range_flags`` / ``ref._thresh_flags``).  Each launcher returns
``(out, launches)`` so the dispatching wrapper in :mod:`.ops` counts only
real launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_WORDS = (torch.int32,)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("popcount")
    cuda_lib.bind(lib.cp_packed_launch, [_P, _P, _I, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.cp_multi_packed_launch,
                  [_P, _P, _P, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.fused_verify_launch,
                  [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.agg_packed_launch,
                  [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    cuda_lib.bind(lib.pair_packed_launch,
                  [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P])
    return lib


def _flags(lvs, uvs, device) -> torch.Tensor:
    """(Q, 2) int32 range flags on ``device``.  They go through pinned host
    memory so the copy does not block the host: a copy from pageable
    memory would wait for every launch queued before it."""
    fl = ref._range_flags(lvs, uvs).reshape(-1, 2)
    if ref._host_f32(uvs).size != fl.shape[0]:
        raise ValueError("lvs and uvs must have the same length")
    return torch.from_numpy(fl).pin_memory().to(device, non_blocking=True)


def cp_count_packed_cuda(packed: torch.Tensor, rois, lv, uv):
    """(B, H, words) int32, (B, 4), lv, uv → ((B,) int32, launches)."""
    cuda_lib.require_cuda(packed, "packed", _WORDS)
    b, h, nw = packed.shape
    dev = packed.device
    rois = cuda_lib.int32_rows(rois, dev, (b, 4))
    f1, f0 = (int(f) for f in ref._range_flags(lv, uv))
    if b == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), 0
    out = torch.empty(b, dtype=torch.int32, device=dev)
    rc = _lib().cp_packed_launch(packed.data_ptr(), rois.data_ptr(), f1, f0,
                                 b, h, nw, out.data_ptr(),
                                 cuda_lib.stream(dev))
    cuda_lib.check(rc, "cp_count_packed")
    return out, 1


def cp_count_multi_packed_cuda(packed: torch.Tensor, rois, lvs, uvs):
    """(B, H, words), (Q, B, 4), (Q,), (Q,) → ((Q, B) int32, launches)."""
    cuda_lib.require_cuda(packed, "packed", _WORDS)
    b, h, nw = packed.shape
    dev = packed.device
    flags = _flags(lvs, uvs, dev)
    q = flags.shape[0]
    rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
    if q == 0 or b == 0:
        return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
    out = torch.empty((q, b), dtype=torch.int32, device=dev)
    rc = _lib().cp_multi_packed_launch(
        packed.data_ptr(), rois.data_ptr(), flags.data_ptr(), q, b, h, nw,
        out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "cp_count_multi_packed")
    return out, 1


def fused_bounds_verify_cuda(packed: torch.Tensor, rois, lvs, uvs, decided,
                             lb):
    """(B, H, words), (Q, B, 4), (Q,), (Q,), decided (Q, B) 0/1, lb (Q, B)
    → ((Q, B) int32, launches)."""
    cuda_lib.require_cuda(packed, "packed", _WORDS)
    b, h, nw = packed.shape
    dev = packed.device
    flags = _flags(lvs, uvs, dev)
    q = flags.shape[0]
    rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
    decided = cuda_lib.int32_rows(decided, dev, (q, b), "decided")
    lb = cuda_lib.int32_rows(lb, dev, (q, b), "lb")
    if q == 0 or b == 0:
        return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
    out = torch.empty((q, b), dtype=torch.int32, device=dev)
    rc = _lib().fused_verify_launch(
        packed.data_ptr(), rois.data_ptr(), flags.data_ptr(),
        decided.data_ptr(), lb.data_ptr(), q, b, h, nw,
        out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "fused_bounds_verify")
    return out, 1


def mask_agg_counts_packed_cuda(group_packed: torch.Tensor, rois, thresh):
    """(N, S, H, words), (N, 4), t → ((inter (N,), union (N,)), launches)."""
    cuda_lib.require_cuda(group_packed, "group_packed", _WORDS)
    n, s, h, nw = group_packed.shape
    dev = group_packed.device
    rois = cuda_lib.int32_rows(rois, dev, (n, 4))
    f1, f0 = ref._thresh_flags(thresh)
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return (empty, empty.clone()), 0
    inter = torch.empty(n, dtype=torch.int32, device=dev)
    union = torch.empty(n, dtype=torch.int32, device=dev)
    rc = _lib().agg_packed_launch(
        group_packed.data_ptr(), rois.data_ptr(), f1, f0, n, s, h, nw,
        inter.data_ptr(), union.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "mask_agg_counts_packed")
    return (inter, union), 1


def pair_counts_packed_cuda(packed_a: torch.Tensor, packed_b: torch.Tensor,
                            rois, ta, tb):
    """(B, H, words) x 2, (B, 4), ta, tb → ((inter, union, diff) each (B,)
    int32, launches); ``diff`` is |A∖B|."""
    cuda_lib.require_cuda(packed_a, "packed_a", _WORDS)
    cuda_lib.require_cuda(packed_b, "packed_b", _WORDS)
    if packed_b.shape != packed_a.shape:
        raise ValueError(f"packed_b shape {tuple(packed_b.shape)} differs "
                         f"from packed_a {tuple(packed_a.shape)}")
    b, h, nw = packed_a.shape
    dev = packed_a.device
    rois = cuda_lib.int32_rows(rois, dev, (b, 4))
    fa1, fa0 = ref._thresh_flags(ta)
    fb1, fb0 = ref._thresh_flags(tb)
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    if b == 0:
        return tuple(out), 0
    rc = _lib().pair_packed_launch(
        packed_a.data_ptr(), packed_b.data_ptr(), rois.data_ptr(), fa1, fa0,
        fb1, fb0, b, h, nw, out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "pair_counts_packed")
    return tuple(out), 1
