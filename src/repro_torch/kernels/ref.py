"""Plain PyTorch versions of every CUDA kernel in this package.

These are the semantics; the kernels are the fast implementations.  The
wrappers in :mod:`.ops` run them for tensors on the CPU (the tests), and
``chip_smoke.py`` holds each kernel against them on the card.  Every
output is an exact int32 count, so agreement means equality.

Thresholds compare in the mask dtype: a Python float is rounded to it
first, as the JAX references' weakly typed scalars and the Pallas
wrappers' casts do.
"""

from __future__ import annotations

import numpy as np
import torch


def _roi_mask(rois: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W) bool — True inside each half-open ROI rectangle."""
    dev = rois.device
    rr = torch.arange(height, device=dev).view(1, height, 1)
    cc = torch.arange(width, device=dev).view(1, 1, width)
    r0, c0, r1, c1 = (rois[:, i].view(-1, 1, 1) for i in range(4))
    return (rr >= r0) & (rr < r1) & (cc >= c0) & (cc < c1)


def _as_dtype(x, t: torch.Tensor) -> torch.Tensor:
    """A scalar threshold (or a (Q,) vector) in ``t``'s dtype and device."""
    return torch.as_tensor(x, dtype=torch.float64).to(t.device).to(t.dtype)


def _rois(rois, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rois).to(device=t.device, dtype=torch.int32)


def _gather(x: torch.Tensor, positions) -> torch.Tensor:
    """``x[positions]`` over the leading axis, or ``x`` without positions."""
    if positions is None:
        return x
    return x[torch.as_tensor(positions, dtype=torch.int64).reshape(-1).to(
        x.device)]


def cp_count_ref(masks: torch.Tensor, rois, lv, uv) -> torch.Tensor:
    """(B, H, W), (B, 4), scalars → (B,) int32 — exact CP."""
    _, h, w = masks.shape
    inside = _roi_mask(_rois(rois, masks), h, w)
    in_range = (masks >= _as_dtype(lv, masks)) & (masks < _as_dtype(uv, masks))
    return (inside & in_range).sum(dim=(1, 2), dtype=torch.int32)


def cp_count_multi_ref(masks: torch.Tensor, rois, lvs, uvs,
                       positions=None) -> torch.Tensor:
    """(B, H, W), (Q, B, 4), (Q,), (Q,) → (Q, B) int32 — the multi-query
    CP pass (one read of the mask bytes answers Q descriptors).  With
    ``positions`` (B,), the batch is ``masks[positions]`` of an (N, H, W)
    array."""
    masks = _gather(masks, positions)
    rois = _rois(rois, masks)
    lvs = torch.as_tensor(lvs).reshape(-1)
    uvs = torch.as_tensor(uvs).reshape(-1)
    lvs = lvs.to(masks.device).to(masks.dtype)
    uvs = uvs.to(masks.device).to(masks.dtype)
    rows = [cp_count_ref(masks, rois[q], lvs[q], uvs[q])
            for q in range(lvs.shape[0])]
    if not rows:
        return torch.zeros((0, masks.shape[0]), dtype=torch.int32,
                           device=masks.device)
    return torch.stack(rows)


def _cell_of(n: int, grid: int, device) -> torch.Tensor:
    """Cell index of each of ``n`` pixel rows/cols for boundaries
    ``(i * n) // grid`` — ``searchsorted(bounds, p, right) - 1`` clipped,
    as ``build_chi_np`` computes it (ragged grids included)."""
    bounds = torch.arange(grid + 1, dtype=torch.int64) * n // grid
    cell = torch.searchsorted(bounds, torch.arange(n), right=True) - 1
    return cell.clamp(0, grid - 1).to(device)


def chi_cell_hist_ref(masks: torch.Tensor, interior_edges,
                      grid: int) -> torch.Tensor:
    """(B, H, W), interior edges (NB-1,) → (B, G, G, NB) int32 per-cell,
    per-bin pixel counts.  A pixel's bin is the number of interior edges
    <= its value, compared in the mask dtype."""
    b, h, w = masks.shape
    g = int(grid)
    edges = _as_dtype(interior_edges, masks).reshape(-1).contiguous()
    nb = edges.shape[0] + 1
    bins = torch.zeros(masks.shape, dtype=torch.int64, device=masks.device)
    for e in edges:
        bins += masks >= e
    cell = (_cell_of(h, g, masks.device)[:, None] * g +
            _cell_of(w, g, masks.device)[None, :])
    key = (cell[None] * nb + bins).reshape(b, -1)
    counts = torch.zeros((b, g * g * nb), dtype=torch.int32,
                         device=masks.device)
    counts.scatter_add_(1, key, torch.ones_like(key, dtype=torch.int32))
    return counts.reshape(b, g, g, nb)


def mask_agg_counts_ref(group_masks: torch.Tensor, rois, thresh):
    """(N, S, H, W), (N, 4), scalar → (inter (N,), union (N,)) int32:
    counts of the thresholded intersection / union inside each ROI."""
    _, _, h, w = group_masks.shape
    binary = group_masks > _as_dtype(thresh, group_masks)
    inter = binary.all(dim=1)
    union = binary.any(dim=1)
    inside = _roi_mask(_rois(rois, group_masks), h, w)
    return ((inter & inside).sum(dim=(1, 2), dtype=torch.int32),
            (union & inside).sum(dim=(1, 2), dtype=torch.int32))


def pair_counts_ref(masks_a: torch.Tensor, masks_b: torch.Tensor, rois, ta,
                    tb):
    """(B, H, W) x 2, (B, 4), scalars → (inter, union, diff) each (B,)
    int32: counts of A∩B, A∪B and A∖B inside each pair's ROI, with
    A = ``masks_a > ta`` and B = ``masks_b > tb`` compared in the mask
    dtype — the dual-mask verification primitive behind IoU and
    discrepancy queries (one pass over both masks)."""
    _, h, w = masks_a.shape
    ba = masks_a > _as_dtype(ta, masks_a)
    bb = masks_b > _as_dtype(tb, masks_b)
    inside = _roi_mask(_rois(rois, masks_a), h, w)
    return ((inside & ba & bb).sum(dim=(1, 2), dtype=torch.int32),
            (inside & (ba | bb)).sum(dim=(1, 2), dtype=torch.int32),
            (inside & ba & ~bb).sum(dim=(1, 2), dtype=torch.int32))


# -- bitpacked binary-mask tier ----------------------------------------------
#
# Packed masks are (…, H, words) int32 tensors: the bit view of the store's
# little-endian uint32 words (bit i of word k is pixel column 32k + i; tail
# bits past W are zero).  The arithmetic below widens each word to int64
# and keeps it in [0, 2**32), so shifts are logical and the uint32 algebra
# of the JAX references holds unchanged.

_WORD = 32
_LOW32 = 0xFFFFFFFF


def _words(x: torch.Tensor) -> torch.Tensor:
    """Packed words as int64 values in [0, 2**32)."""
    if x.dtype != torch.int32:
        raise TypeError(f"packed words must be the int32 bit view of the "
                        f"uint32 words, got {x.dtype}")
    return x.to(torch.int64) & _LOW32


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2**32) (int64 in, int64 out) — the SWAR
    popcount of the JAX reference, on int64 lanes."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _mask_lt(n: torch.Tensor) -> torch.Tensor:
    """Bits [0, clip(n, 0, 32)) set: 0 for n <= 0, all 32 for n >= 32."""
    return (torch.ones_like(n) << n.clamp(0, _WORD)) - 1


def _span_mask(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Bits [clip(lo, 0, 32), clip(hi, 0, 32)) set."""
    return _mask_lt(hi) & ~_mask_lt(lo)


def _effective_word(w: torch.Tensor, f1: int, f0: int) -> torch.Tensor:
    """Bits where ``value > t`` holds on a binary mask, given the flags
    ``f1 = (t < 1)`` and ``f0 = (t < 0)``.  The complement sets the tail
    bits past W; the span mask removes them at count time."""
    zero = torch.zeros_like(w)
    return (w if f1 else zero) | ((~w & _LOW32) if f0 else zero)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _range_flags(lv, uv) -> np.ndarray:
    """CP range [lv, uv) on binary values → int32 flags ``(…, 2)`` =
    (f1, f0) with f1 = (lv <= 1 < uv), f0 = (lv <= 0 < uv).  lv and uv are
    rounded to float32 first, as the JAX wrappers do."""
    lv, uv = _host_f32(lv), _host_f32(uv)
    f1 = (lv <= np.float32(1)) & (np.float32(1) < uv)
    f0 = (lv <= np.float32(0)) & (np.float32(0) < uv)
    return np.stack([f1, f0], axis=-1).astype(np.int32)


def _thresh_flags(t) -> tuple:
    """``value > t`` on binary values → (f1, f0) = (t < 1, t < 0), with t
    rounded to float32 first (0.99999999 rounds to 1.0: f1 = 0)."""
    t = _host_f32(t)
    return int(t < np.float32(1)), int(t < np.float32(0))


def _valid_words(rois: torch.Tensor, h: int, nw: int) -> torch.Tensor:
    """(B, 4) → (B, h, nw) int64 per-word ROI coverage: span masks on rows
    in [r0, r1), zero elsewhere.  Columns are clipped to [0, 32·nw) by the
    span masks themselves, not to W."""
    dev = rois.device
    rr = torch.arange(h, device=dev).view(1, h, 1)
    base = (torch.arange(nw, device=dev) * _WORD).view(1, 1, nw)
    r0, c0, r1, c1 = (rois[:, i].to(torch.int64).view(-1, 1, 1)
                      for i in range(4))
    span = _span_mask(c0 - base, c1 - base)
    return torch.where((rr >= r0) & (rr < r1), span, torch.zeros_like(span))


def _count(words: torch.Tensor, valid: torch.Tensor, f1: int,
           f0: int) -> torch.Tensor:
    """CP on binary values: f1·ones + f0·(area − ones) per mask."""
    ones = _popcount32(words & valid).sum(dim=(1, 2))
    area = _popcount32(valid).sum(dim=(1, 2))
    return (int(f1) * ones + int(f0) * (area - ones)).to(torch.int32)


def cp_count_packed_ref(packed: torch.Tensor, rois, lv, uv) -> torch.Tensor:
    """(B, H, words) int32 bit view, (B, 4), lv, uv → (B,) int32 exact CP,
    equal to ``cp_count_ref`` on the unpacked binary masks."""
    _, h, nw = packed.shape
    f1, f0 = _range_flags(lv, uv)
    return _count(_words(packed), _valid_words(_rois(rois, packed), h, nw),
                  f1, f0)


def cp_count_multi_packed_ref(packed: torch.Tensor, rois, lvs, uvs,
                              positions=None) -> torch.Tensor:
    """(B, H, words), (Q, B, 4), (Q,), (Q,) → (Q, B) int32.  With
    ``positions`` (B,), the batch is ``packed[positions]`` of an
    (N, H, words) array."""
    packed = _gather(packed, positions)
    _, h, nw = packed.shape
    rois = _rois(rois, packed)
    flags = _range_flags(lvs, uvs).reshape(-1, 2)
    words = _words(packed)
    rows = [_count(words, _valid_words(rois[q], h, nw), *flags[q])
            for q in range(flags.shape[0])]
    if not rows:
        return torch.zeros((0, packed.shape[0]), dtype=torch.int32,
                           device=packed.device)
    return torch.stack(rows)


def mask_agg_counts_packed_ref(group_packed: torch.Tensor, rois, thresh):
    """(N, S, H, words), (N, 4), t → (inter (N,), union (N,)) int32: set
    bits of the AND / OR over S of the effective words inside each ROI.
    An empty member set gives AND = all ones, OR = 0, as for float masks."""
    n, s, h, nw = group_packed.shape
    f1, f0 = _thresh_flags(thresh)
    words = _words(group_packed)
    inter = torch.full((n, h, nw), _LOW32, dtype=torch.int64,
                       device=group_packed.device)
    union = torch.zeros_like(inter)
    for si in range(s):
        eff = _effective_word(words[:, si], f1, f0)
        inter &= eff
        union |= eff
    valid = _valid_words(_rois(rois, group_packed), h, nw)
    return (_popcount32(inter & valid).sum(dim=(1, 2)).to(torch.int32),
            _popcount32(union & valid).sum(dim=(1, 2)).to(torch.int32))


def fused_bounds_verify_ref(packed: torch.Tensor, rois, lvs, uvs, decided,
                            lb, positions=None) -> torch.Tensor:
    """The bounds+verify megakernel: (B, H, words), (Q, B, 4), (Q,), (Q,),
    decided (Q, B) 0/1, lb (Q, B) → (Q, B) int32.  Decided entries pass
    their CHI bound through; the rest are counted from the words.  With
    ``positions`` (B,), the batch is ``packed[positions]`` of an
    (N, H, words) array."""
    packed = _gather(packed, positions)
    counts = cp_count_multi_packed_ref(packed, rois, lvs, uvs)
    dev = packed.device
    decided = torch.as_tensor(decided).to(dev)
    lb = torch.as_tensor(lb).to(device=dev, dtype=torch.int32)
    return torch.where(decided != 0, lb, counts)


def pair_counts_packed_ref(packed_a: torch.Tensor, packed_b: torch.Tensor,
                           rois, ta, tb, pos_a=None, pos_b=None):
    """(B, H, words) x 2 int32 bit views, (B, 4), ta, tb → (inter, union,
    diff) each (B,) int32: set bits of ea & eb, ea | eb and ea & ~eb inside
    each ROI, where ``ea``/``eb`` are the effective words of ``value > t``
    (flags from float32-rounded ``ta``/``tb``), equal to
    ``pair_counts_ref`` on the unpacked binary masks.  With ``pos_a`` /
    ``pos_b`` (B,), that role's batch is ``packed[pos]`` of an
    (N, H, words) array."""
    packed_a, packed_b = _gather(packed_a, pos_a), _gather(packed_b, pos_b)
    _, h, nw = packed_a.shape
    ea = _effective_word(_words(packed_a), *_thresh_flags(ta))
    eb = _effective_word(_words(packed_b), *_thresh_flags(tb))
    valid = _valid_words(_rois(rois, packed_a), h, nw)

    def count(x):
        return _popcount32(x & valid).sum(dim=(1, 2)).to(torch.int32)
    return count(ea & eb), count(ea | eb), count(ea & ~eb)
