"""CUDA popcount kernels over packed binary masks (``csrc/popcount.cu``)
behind ctypes.

The packed tier's verification hot path.  Masks are ``(…, H, words)``
int32 tensors, the bit view of the store's uint32 words.  Five launchers,
each the port of a Pallas kernel in the JAX package's ``popcount.py``:

* :func:`cp_count_packed_cuda` — ``cp_packed_kern`` (``_cp_popcount_kernel``):
  exact CP per mask;
* :func:`cp_count_multi_packed_cuda` — ``cp_multi_block_kern``
  (``_cp_multi_popcount_kernel``): Q descriptors from one read of each mask,
  read in place through ``positions``;
* :func:`fused_bounds_verify_cuda` — ``fused_verify_kern``
  (``_fused_verify_popcount_kernel``): the same with CHI-decided entries
  passed through uncounted — one launch per verification batch;
* :func:`mask_agg_counts_packed_cuda` — ``agg_packed_kern``
  (``_agg_popcount_kernel``): AND / OR over S members;
* :func:`pair_counts_packed_cuda` — ``pair_packed_kern``
  (``_pair_popcount_kernel``): inter / union / diff of two masks per pair,
  each role optionally read in place through its positions.

The two Q-descriptor launchers share one block-per-mask body and take
their small host inputs (flags, ROIs, verdicts, bounds, positions) staged
in one pinned buffer and copied to the card once.  :func:`empty_launch`
launches a kernel that does nothing: its time is the floor under every
small call.

The CP range and the threshold reach the kernels as integer flags,
computed here from float32 values exactly as the JAX wrappers do
(``ref._range_flags`` / ``ref._thresh_flags``).  Each launcher returns
``(out, launches)`` so the dispatching wrapper in :mod:`.ops` counts only
real launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib, ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_WORDS = (torch.int32,)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("popcount")
    cuda_lib.bind(lib.cp_packed_launch, [_P, _P, _I, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.cp_multi_packed_launch,
                  [_P, _P, _L, _P, _P, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.fused_verify_launch,
                  [_P, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P])
    cuda_lib.bind(lib.agg_packed_launch,
                  [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P])
    cuda_lib.bind(lib.pair_packed_launch,
                  [_P, _P, _L, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P])
    cuda_lib.bind(lib.empty_launch, [_P])
    return lib


def _flags(lvs, uvs) -> np.ndarray:
    """(Q, 2) int32 range flags, on the host."""
    fl = ref._range_flags(lvs, uvs).reshape(-1, 2)
    if ref._host_f32(uvs).size != fl.shape[0]:
        raise ValueError("lvs and uvs must have the same length")
    return fl


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


def _on_card(small) -> bool:
    """Whether any small operand is already a CUDA tensor."""
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in small)


def _host_positions(positions):
    """A position list as a (B,) int64 host array, or None."""
    if positions is None:
        return None
    return np.asarray(positions).astype(np.int64, copy=False).reshape(-1)


def _staged(pos, parts, device):
    """Host ``parts`` (and ``pos`` first, where given, so it stays 8-byte
    aligned) in one staged copy → (the card buffer, to keep until the
    launch is queued; pos's device address or None; the parts' addresses)."""
    if pos is None:
        card, addr = cuda_lib.stage(parts, device)
        return card, None, addr
    card, (pos_addr, *addr) = cuda_lib.stage([pos] + parts, device)
    return card, pos_addr, addr


def _multi_launch(words: torch.Tensor, q: int, b: int, flags, rois,
                  positions) -> torch.Tensor:
    """The Q-descriptor kernel on operands given by their device addresses
    (``positions`` None or an address) → (Q, B) int32."""
    n, h, nw = words.shape
    out = torch.empty((q, b), dtype=torch.int32, device=words.device)
    rc = _lib().cp_multi_packed_launch(
        words.data_ptr(), positions, n, flags, rois, q, b, h, nw,
        out.data_ptr(), cuda_lib.stream(words.device))
    cuda_lib.check(rc, "cp_count_multi_packed")
    return out


def cp_count_multi_packed_cuda(packed: torch.Tensor, rois, lvs, uvs,
                               positions=None):
    """(N, H, words), (Q, B, 4), (Q,), (Q,), positions (B,) int64 or None →
    ((Q, B) int32, launches).  Mask ``b`` is ``packed[positions[b]]``, read
    in place (no gather), or ``packed[b]`` without positions; positions
    must lie in [0, N) (the kernel traps otherwise, as an index out of
    range does).  Host ROIs and positions go to the card with the flags in
    one staged copy; when either is already a CUDA tensor, both are
    converted on the card instead, with no copy back to the host."""
    cuda_lib.require_cuda(packed, "packed", _WORDS)
    n = packed.shape[0]
    dev = packed.device
    flags = _flags(lvs, uvs)
    q = flags.shape[0]
    if _on_card((rois, positions)):
        pos = _positions(positions, dev)
        b = n if pos is None else pos.shape[0]
        rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
        if q == 0 or b == 0:
            return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
        flags = cuda_lib.to_card(flags, dev)
        return _multi_launch(packed, q, b, flags.data_ptr(), rois.data_ptr(),
                             None if pos is None else pos.data_ptr()), 1
    pos = _host_positions(positions)
    b = n if pos is None else pos.shape[0]
    rois = _host_rows(rois, np.int32, (q, b, 4), "rois")
    if q == 0 or b == 0:
        return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
    card, pos_addr, (flags_addr, rois_addr) = _staged(pos, [flags, rois], dev)
    return _multi_launch(packed, q, b, flags_addr, rois_addr, pos_addr), 1


def _host_rows(x, dtype, shape, what: str) -> np.ndarray:
    """A small host operand as an array of ``dtype`` and ``shape``."""
    a = np.asarray(x)
    if a.shape != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {a.shape}")
    return a.astype(dtype, copy=False)


def _fused_launch(words: torch.Tensor, q: int, b: int, flags, rois, decided,
                  lb, positions) -> torch.Tensor:
    """The megakernel on operands given by their device addresses
    (``positions`` None or an address) → (Q, B) int32."""
    n, h, nw = words.shape
    out = torch.empty((q, b), dtype=torch.int32, device=words.device)
    rc = _lib().fused_verify_launch(
        words.data_ptr(), positions, n, flags, rois, decided, lb, q, b, h, nw,
        out.data_ptr(), cuda_lib.stream(words.device))
    cuda_lib.check(rc, "fused_bounds_verify")
    return out


def fused_verify_launch(words: torch.Tensor, flags, rois, decided, lb,
                        positions=None) -> torch.Tensor:
    """The megakernel on operands already on the card: words (N, H, nw)
    int32, flags (Q, 2), rois (Q, B, 4), decided and lb (Q, B) int32,
    positions (B,) int64 or None (then B = N) → (Q, B) int32."""
    q, b = decided.shape
    return _fused_launch(words, q, b, flags.data_ptr(), rois.data_ptr(),
                         decided.data_ptr(), lb.data_ptr(),
                         None if positions is None else positions.data_ptr())


def fused_bounds_verify_cuda(packed: torch.Tensor, rois, lvs, uvs, decided,
                             lb, positions=None):
    """(N, H, words), (Q, B, 4), (Q,), (Q,), decided (Q, B) 0/1, lb (Q, B),
    positions (B,) int64 or None → ((Q, B) int32, launches).  Mask ``b`` is
    ``packed[positions[b]]``, read in place (no gather), or ``packed[b]``
    without positions; positions must lie in [0, N) (the kernel traps
    otherwise, as an index out of range does).  Host operands (flags, ROIs,
    verdicts, bounds, positions) reach the card in one staged copy; when
    any of them is already a CUDA tensor, they are all converted on the
    card instead, with no copy back to the host."""
    cuda_lib.require_cuda(packed, "packed", _WORDS)
    n = packed.shape[0]
    dev = packed.device
    flags = _flags(lvs, uvs)
    q = flags.shape[0]
    if _on_card((rois, decided, lb, positions)):
        pos = _positions(positions, dev)
        b = n if pos is None else pos.shape[0]
        rois = cuda_lib.int32_rows(rois, dev, (q, b, 4))
        decided = cuda_lib.int32_rows(torch.as_tensor(decided, device=dev)
                                      != 0, dev, (q, b), "decided")
        lb = cuda_lib.int32_rows(lb, dev, (q, b), "lb")
        if q == 0 or b == 0:
            return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
        return fused_verify_launch(packed, cuda_lib.to_card(flags, dev),
                                   rois, decided, lb, pos), 1
    pos = _host_positions(positions)
    b = n if pos is None else pos.shape[0]
    rois = _host_rows(rois, np.int32, (q, b, 4), "rois")
    decided = _host_rows(decided, np.int32, (q, b), "decided") != 0
    lb = _host_rows(lb, np.int32, (q, b), "lb")
    if q == 0 or b == 0:
        return torch.zeros((q, b), dtype=torch.int32, device=dev), 0
    card, pos_addr, addr = _staged(
        pos, [flags, rois, decided.astype(np.int32), lb], dev)
    return _fused_launch(packed, q, b, *addr, pos_addr), 1


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


def _positions(pos, device):
    """A position list as a contiguous (B,) int64 tensor on ``device``."""
    if pos is None:
        return None
    return torch.as_tensor(pos).to(device, torch.int64).reshape(
        -1).contiguous()


def pair_counts_packed_cuda(packed_a: torch.Tensor, packed_b: torch.Tensor,
                            rois, ta, tb, pos_a=None, pos_b=None):
    """(Na, H, words), (Nb, H, words), (B, 4), ta, tb, pos_a, pos_b (B,)
    int64 or None → ((inter, union, diff) each (B,) int32, launches);
    ``diff`` is |A∖B|.  Pair ``p`` is ``packed_a[pos_a[p]]`` and
    ``packed_b[pos_b[p]]``, each read in place, or row ``p`` of an array
    whose positions are None; positions outside the array trap."""
    cuda_lib.require_cuda(packed_a, "packed_a", _WORDS)
    cuda_lib.require_cuda(packed_b, "packed_b", _WORDS)
    if packed_b.shape[1:] != packed_a.shape[1:]:
        raise ValueError(f"packed_b rows {tuple(packed_b.shape[1:])} differ "
                         f"from packed_a {tuple(packed_a.shape[1:])}")
    na, h, nw = packed_a.shape
    nb = packed_b.shape[0]
    dev = packed_a.device
    pos_a, pos_b = _positions(pos_a, dev), _positions(pos_b, dev)
    b = na if pos_a is None else pos_a.shape[0]
    if (nb if pos_b is None else pos_b.shape[0]) != b:
        raise ValueError("the two roles must name the same number of masks")
    rois = cuda_lib.int32_rows(rois, dev, (b, 4))
    fa1, fa0 = ref._thresh_flags(ta)
    fb1, fb0 = ref._thresh_flags(tb)
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    if b == 0:
        return tuple(out), 0
    rc = _lib().pair_packed_launch(
        packed_a.data_ptr(), None if pos_a is None else pos_a.data_ptr(), na,
        packed_b.data_ptr(), None if pos_b is None else pos_b.data_ptr(), nb,
        rois.data_ptr(), fa1, fa0, fb1, fb0, b, h, nw, out.data_ptr(),
        cuda_lib.stream(dev))
    cuda_lib.check(rc, "pair_counts_packed")
    return tuple(out), 1


def empty_launch(device) -> None:
    """Launch the empty kernel once on ``device``'s current stream."""
    cuda_lib.check(_lib().empty_launch(cuda_lib.stream(torch.device(device))),
                   "empty")
