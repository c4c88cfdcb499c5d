"""PyTorch port on the card: each CUDA kernel against its plain version.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build
with ``nvcc`` at first use); elsewhere they skip with a reason.  Run them
on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs come from fixed numpy seeds; every output is an int32 count, so
kernel and plain version must agree exactly.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.data.masks import object_boxes, saliency_masks
from repro_torch.core import CHIConfig, MaskStore, queries
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = [(3, 64, 64), (2, 128, 256), (5, 96, 160), (4, 32, 512),
          (3, 50, 70), (2, 224, 224)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, seed, device):
    b, h, w = shape
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
    r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
    c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
    rois = torch.from_numpy(np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]],
                                     1).astype(np.int32)).to(device)
    return m, rois


def _eq(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_cp_kernels_match_plain(cuda, shape, dtype):
    m, rois = _inputs(shape, 1, cuda)
    m = m.to(dtype)
    before = ops.cp_count.launches
    for lv, uv in ((0.25, 0.8), (0.5, 0.5), (0.7, 0.802)):
        _eq(ops.cp_count(m, rois, lv, uv), ref.cp_count_ref(m, rois, lv, uv))
    assert ops.cp_count.launches == before + 3
    rois_q = torch.stack([rois, rois.flip(0)])
    lvs, uvs = torch.tensor([0.1, 0.6]), torch.tensor([0.5, 3.4e38])
    _eq(ops.cp_count_multi(m, rois_q, lvs, uvs),
        ref.cp_count_multi_ref(m, rois_q, lvs, uvs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mask_agg_kernel_matches_plain(cuda, shape, dtype):
    m, rois = _inputs(shape, 2, cuda)
    b, h, w = shape
    g = m.to(dtype)[: (b // 2) * 2].reshape(b // 2, 2, h, w).contiguous()
    gi, gu = ops.mask_agg_counts(g, rois[: b // 2], 0.5)
    wi, wu = ref.mask_agg_counts_ref(g, rois[: b // 2], 0.5)
    _eq(gi, wi)
    _eq(gu, wu)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(3, 16, 33), (2, 5, 1100)])
def test_pair_kernel_matches_plain(cuda, shape, dtype):
    a, rois = _inputs(shape, 8, cuda)
    b, _ = _inputs(shape, 9, cuda)
    # pixels on a threshold: bf16 0.80078125 is not above ta = 0.8 in bf16
    a[:, ::2, :] = 0.80078125
    b[:, :, ::3] = 0.5
    a, b = a.to(dtype), b.to(dtype)
    before = ops.pair_counts.launches
    for ta, tb in ((0.8, 0.5), (0.5, 0.8), (0.3, 0.3), (-1.0, 2.0)):
        for got, want in zip(ops.pair_counts(a, b, rois, ta, tb),
                             ref.pair_counts_ref(a, b, rois, ta, tb)):
            _eq(got, want)
    assert ops.pair_counts.launches == before + 4
    # a copy one element off 16-byte alignment takes the element path
    buf = torch.empty(a.numel() + 1, dtype=dtype, device=cuda)
    a1 = buf[1:].view(a.shape)
    a1.copy_(a)
    for got, want in zip(ops.pair_counts(a1, b, rois, 0.8, 0.5),
                         ref.pair_counts_ref(a1, b, rois, 0.8, 0.5)):
        _eq(got, want)


@pytest.mark.parametrize("grid", [4, 7, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_chi_kernel_matches_plain_with_bin_edge_values(cuda, shape, grid):
    m, _ = _inputs(shape, 3, cuda)
    rng = np.random.default_rng(4)
    pick = torch.from_numpy(rng.random(shape) < 0.3).to(cuda)
    edge_vals = torch.from_numpy(
        (rng.integers(0, 17, shape) / 16).astype(np.float32)).to(cuda)
    m = torch.where(pick, edge_vals, m)
    edges = torch.arange(1, 16, dtype=torch.float32) / 16
    _eq(ops.chi_cell_hist(m, edges, grid),
        ref.chi_cell_hist_ref(m, edges, grid))


def _multi_rois(rng, q, b, h, w):
    """Random ROIs with the edge cases: columns that start and end inside
    a 16-byte chunk, an empty ROI, one past the mask's edges."""
    r = np.sort(rng.integers(-2, h + 3, (q, b, 2)), axis=2)
    c = np.sort(rng.integers(-2, w + 3, (q, b, 2)), axis=2)
    rois = np.stack([r[..., 0], c[..., 0], r[..., 1], c[..., 1]], -1)
    if b:
        rois[0, 0] = [1, 3, h - 1, w - 3]
        rois[-1, -1] = [4, 5, 4, 9]
    return torch.from_numpy(rois.astype(np.int32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 8, 9, 17])
def test_cp_multi_kernel_buckets_and_positions(cuda, q, dtype):
    """Q in every register bucket and above the largest; positions that
    are absent, unsorted, repeated and empty; 16-byte and element paths
    (W = 33, 70, and a base one element off alignment)."""
    rng = np.random.default_rng(40 + q)
    for n, h, w in ((7, 40, 64), (6, 33, 70), (5, 9, 33), (4, 224, 224)):
        m = torch.from_numpy(rng.random((n, h, w), dtype=np.float32))
        m[:, ::3, ::2] = 0.80078125
        m = m.to(cuda).to(dtype)
        lvs = np.sort(rng.random(q)).astype(np.float32)
        lvs[0] = 0.802
        uvs = (lvs + 0.5).astype(np.float32)
        uvs[-1] = 3.4e38
        for pos in (None, [n - 1, 0, 2, 1], [2, 2, 0, 2, n - 1, 0], []):
            b = n if pos is None else len(pos)
            rois = _multi_rois(rng, q, b, h, w).to(cuda)
            p = None if pos is None else torch.tensor(pos, device=cuda)
            before = ops.cp_count_multi.launches
            _eq(ops.cp_count_multi(m, rois, lvs, uvs, p),
                ref.cp_count_multi_ref(m, rois, lvs, uvs, p))
            assert ops.cp_count_multi.launches == before + (b > 0)
        buf = torch.empty(m.numel() + 1, dtype=dtype, device=cuda)
        m1 = buf[1:].view(m.shape)
        m1.copy_(m)
        p = torch.tensor([n - 1, 0, 0], device=cuda)
        rois = _multi_rois(rng, q, 3, h, w).to(cuda)
        _eq(ops.cp_count_multi(m1, rois, lvs, uvs, p),
            ref.cp_count_multi_ref(m1, rois, lvs, uvs, p))


@pytest.mark.parametrize("dtype", DTYPES)
def test_cp_multi_kernel_large_batch_writes_every_entry(cuda, dtype):
    """A batch that fills the card, 1,500 positions over 300 resident
    masks: one block per mask writes each (q, b) once into an output that
    is never zeroed."""
    rng = np.random.default_rng(7)
    n, h, w, b = 300, 24, 40, 1500
    m = torch.from_numpy(rng.random((n, h, w), dtype=np.float32))
    m = m.to(cuda).to(dtype)
    pos = torch.from_numpy(rng.integers(0, n, b)).to(cuda)
    for q in (1, 3, 9):
        rois = _multi_rois(rng, q, b, h, w).to(cuda)
        lvs = np.linspace(0.0, 0.6, q).astype(np.float32)
        uvs = (lvs + 0.3).astype(np.float32)
        _eq(ops.cp_count_multi(m, rois, lvs, uvs, pos),
            ref.cp_count_multi_ref(m, rois, lvs, uvs, pos))
        _eq(ops.cp_count_multi(m[pos.cpu()].contiguous(), rois, lvs, uvs),
            ref.cp_count_multi_ref(m, rois, lvs, uvs, pos))


@pytest.mark.parametrize("nb", [1, 2, 5, 16, 17])
@pytest.mark.parametrize("shape", [(600, 20, 36), (600, 18, 70),
                                   (3, 33, 64), (2, 5, 9)])
def test_chi_kernel_bins_bands_and_widths(cuda, shape, nb):
    """Whole-mask blocks (a batch that fills the card) and banded ones,
    widths that are not a multiple of 4, one-bin and binary masks, pixels
    on the edges, NaN and +-inf, ragged grids."""
    rng = np.random.default_rng(nb)
    m = rng.random(shape, dtype=np.float32)
    pick = rng.random(shape) < 0.3
    m[pick] = (rng.integers(0, nb + 1, pick.sum()) / nb).astype(np.float32)
    m.reshape(-1)[:5] = [np.nan, np.inf, -np.inf, 1.0, -0.25]
    edges = torch.arange(1, nb, dtype=torch.float32) / nb
    for x in (m, (m > 0.5).astype(np.float32), np.full(shape, 0.3, np.float32)):
        t = torch.from_numpy(x).to(cuda)
        for grid in (16, 7, 1):
            _eq(ops.chi_cell_hist(t, edges, grid),
                ref.chi_cell_hist_ref(t, edges, grid))
    buf = torch.empty(m.size + 1, device=cuda)
    t1 = buf[1:].view(shape)
    t1.copy_(torch.from_numpy(m))
    _eq(ops.chi_cell_hist(t1, edges, 16), ref.chi_cell_hist_ref(t1, edges, 16))


def test_chi_kernel_refuses_unsorted_edges(cuda):
    m = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError):
        ops.chi_cell_hist(m, torch.tensor([0.5, 0.25]), 4)
    with pytest.raises(ValueError):
        ops.chi_cell_hist(m, torch.tensor([0.25, float("nan")]), 4)


def test_store_and_queries_match_cpu(cuda):
    n, h, w = 64, 64, 64
    rois = object_boxes(n, h, w, seed=1)
    masks, _ = saliency_masks(n, h, w, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=h, width=w)
    stores = {}
    for d in ("cpu", cuda):
        s = MaskStore.create_memory(masks[:32], meta[:32], cfg, device=d)
        s.append(masks[32:], meta[32:])
        stores[str(d)] = s
    np.testing.assert_array_equal(stores["cuda"].chi_host(),
                                  stores["cpu"].chi_host())
    for sql in (queries.SCENARIO1_TOPK, queries.SCENARIO2_TOPK,
                queries.SCENARIO3_IOU):
        want, _ = queries.run(sql, stores["cpu"], provided_rois=rois)
        for backend in ("host", "device"):
            got, _ = queries.run(sql, stores["cuda"], provided_rois=rois,
                                 backend=backend)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# -- bitpacked tier: the four popcount kernels ---------------------------------

PACKED_SHAPES = [(3, 64, 33), (5, 96, 40), (2, 224, 224), (4, 32, 1100),
                 (1, 7, 1), (6, 50, 70)]


def _packed_inputs(shape, seed, device):
    """int32 word views of random binary masks, and ROIs with the edge
    cases: unclipped past W and past the last word, empty, negative starts,
    columns on word edges."""
    from repro_torch.core.packing import pack_masks
    b, h, w = shape
    rng = np.random.default_rng(seed)
    words = pack_masks(rng.random(shape) < 0.4).view(np.int32)
    r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
    c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
    rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
    edges = [(0, 0, h, w + 31), (-3, -5, h + 2, 64), (2, 32, h, 64),
             (1, 3, 1, 9), (0, 31, h, 33), (4, 9, 2, 30)]
    rois[:min(b, len(edges))] = edges[:b]
    return (torch.from_numpy(words).to(device),
            torch.from_numpy(rois.astype(np.int32)).to(device))


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_popcount_kernels_match_plain(cuda, shape):
    m, rois = _packed_inputs(shape, 5, cuda)
    b = shape[0]
    before = ops.cp_count_packed.launches
    ranges = ((0.5, 1.5), (-0.5, 0.5), (0.0, 1.0), (1.0, 1.5), (0.5, 0.5))
    for lv, uv in ranges:
        _eq(ops.cp_count_packed(m, rois, lv, uv),
            ref.cp_count_packed_ref(m, rois, lv, uv))
    assert ops.cp_count_packed.launches == before + len(ranges)
    rois_q = torch.stack([rois, rois.flip(0), rois])
    lvs = np.float32([0.5, -0.5, 0.0])
    uvs = np.float32([1.5, 0.5, 3.4e38])
    _eq(ops.cp_count_multi_packed(m, rois_q, lvs, uvs),
        ref.cp_count_multi_packed_ref(m, rois_q, lvs, uvs))
    rng = np.random.default_rng(6)
    lb = rng.integers(0, 1000, (3, b)).astype(np.int32)
    for decided in (rng.random((3, b)) < 0.5, np.ones((3, b), bool),
                    np.zeros((3, b), bool)):
        decided = decided.astype(np.int32)
        _eq(ops.fused_bounds_verify(m, rois_q, lvs, uvs, decided, lb),
            ref.fused_bounds_verify_ref(m, rois_q, lvs, uvs, decided, lb))


@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_mask_agg_packed_kernel_matches_plain(cuda, shape, s):
    b, h, w = shape
    m, rois = _packed_inputs((b * s, h, w), 7, cuda)
    grp = m.reshape(b, s, h, -1).contiguous()
    for t in (-0.5, 0.0, 0.5, 1.0, 1.5):
        gi, gu = ops.mask_agg_counts_packed(grp, rois[:b], t)
        wi, wu = ref.mask_agg_counts_packed_ref(grp, rois[:b], t)
        _eq(gi, wi)
        _eq(gu, wu)


@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_pair_packed_kernel_matches_plain(cuda, shape):
    a, rois = _packed_inputs(shape, 10, cuda)
    b, _ = _packed_inputs(shape, 11, cuda)
    before = ops.pair_counts_packed.launches
    ts = (-0.5, 0.0, 0.5, 1.0, 1.5)
    for ta in ts:
        for tb in ts:
            for got, want in zip(
                    ops.pair_counts_packed(a, b, rois, ta, tb),
                    ref.pair_counts_packed_ref(a, b, rois, ta, tb)):
                _eq(got, want)
    assert ops.pair_counts_packed.launches == before + len(ts) ** 2


def _misaligned(words):
    """The same words in a copy whose base is one word past a 16-byte
    boundary: the megakernel stages such planes word by word."""
    buf = torch.empty(words.numel() + 1, dtype=words.dtype,
                      device=words.device)
    out = buf[1:].view(words.shape)
    out.copy_(words)
    return out


POSITIONS = (None, "repeat", "unsorted", "empty")


def _pos(kind, n, device):
    """Position lists over n resident masks: none, repeated, out of
    order, empty."""
    if kind is None:
        return None
    pos = {"repeat": [n - 1, 0, n - 1, 0, 1 % n, 1 % n],
           "unsorted": list(range(n))[::-1] + [n // 2],
           "empty": []}[kind]
    return torch.tensor(pos, dtype=torch.int64, device=device)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_fused_verify_kernel_positions_and_verdicts(cuda, shape, aligned):
    """With and without positions (repeated, unsorted, empty), verdicts all
    decided, none and mixed, a mask whose every entry is decided (its
    output is lb), on aligned and misaligned planes."""
    words, rois = _packed_inputs(shape, 21, cuda)
    if not aligned:
        words = _misaligned(words)
    n = shape[0]
    rng = np.random.default_rng(22)
    lvs = np.float32([0.5, -0.5, 0.0, 1.0])
    uvs = np.float32([1.5, 0.5, 3.4e38, 1.5])
    for kind in POSITIONS:
        pos = _pos(kind, n, cuda)
        b = n if pos is None else len(pos)
        rois_q = torch.stack([rois, rois.flip(0), rois, rois])
        rois_q = rois_q if pos is None else rois_q[:, pos]
        lb = rng.integers(0, 1000, (4, b)).astype(np.int32)
        mixed = rng.random((4, b)) < 0.5
        if b:
            mixed[:, 0] = True      # every entry of mask 0 decided
            mixed[:, -1] = False
        for dec in (mixed, np.ones((4, b), bool), np.zeros((4, b), bool)):
            dec = dec.astype(np.int32)
            before = ops.fused_bounds_verify.launches
            got = ops.fused_bounds_verify(words, rois_q, lvs, uvs, dec, lb,
                                          pos)
            _eq(got, ref.fused_bounds_verify_ref(words, rois_q, lvs, uvs,
                                                 dec, lb, pos))
            assert ops.fused_bounds_verify.launches == before + (b > 0)
            if b:   # the entries of mask 0 that are decided read lb
                sel = dec[:, 0] == 1
                np.testing.assert_array_equal(got[:, 0].cpu().numpy()[sel],
                                              lb[sel, 0])


@pytest.mark.parametrize("b", [1, 7, 708, 4000])
def test_fused_verify_kernel_batch_sizes(cuda, b):
    """B from one mask to several thousand positions over a resident
    224x224 array (every block writes its entries once into an output
    that is never zeroed), and the same batch gathered."""
    from repro_torch.core.packing import pack_masks
    n, h, w = 300, 224, 224
    rng = np.random.default_rng(b)
    words = torch.from_numpy(pack_masks(rng.random((n, h, w)) < 0.4).view(
        np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, n, b)).to(cuda)
    boxes = object_boxes(b, h, w, seed=b)
    rois_q = torch.from_numpy(np.stack([boxes, np.tile([3, 5, 221, 223],
                                                       (b, 1))]).astype(
        np.int32))
    lvs, uvs = np.float32([0.5, 0.0]), np.float32([1.5, 1.0])
    dec = (rng.random((2, b)) < 0.3).astype(np.int32)
    lb = rng.integers(0, 1000, (2, b)).astype(np.int32)
    want = ref.fused_bounds_verify_ref(words, rois_q, lvs, uvs, dec, lb, pos)
    _eq(ops.fused_bounds_verify(words, rois_q, lvs, uvs, dec, lb, pos), want)
    _eq(ops.fused_bounds_verify(words[pos].contiguous(), rois_q, lvs, uvs,
                                dec, lb), want)


# Q descriptors of the block-per-mask kernel: every register-free count
# from one descriptor to a block of four warps eight times over
MULTI_QS = (1, 2, 3, 4, 5, 8, 9, 17, 32)
# range flag pairs, lv == uv (nothing counted) among them
MULTI_RANGES = ((0.5, 1.5), (-0.5, 0.5), (0.0, 1.0), (0.5, 0.5),
                (1.0, 1.5), (-0.5, 1.5))


def _multi_case(rois, q, h, nw):
    """q descriptors over the masks of ``rois``: the ROIs as given, empty
    ROIs, full rows (0, 0, h, 32 nw) and the ROIs reversed in turn, with the
    range flag pairs of MULTI_RANGES in turn."""
    empty = rois.clone()
    empty[:, 2] = empty[:, 0]
    full = torch.tensor([0, 0, h, 32 * nw], dtype=torch.int32,
                        device=rois.device).expand_as(rois)
    pool = (rois, empty, full, rois.flip(0))
    rois_q = torch.stack([pool[i % 4] for i in range(q)]) if q else \
        rois.new_zeros((0,) + tuple(rois.shape))
    lvs = np.float32([MULTI_RANGES[i % 6][0] for i in range(q)])
    uvs = np.float32([MULTI_RANGES[i % 6][1] for i in range(q)])
    return rois_q, lvs, uvs


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_cp_multi_packed_kernel_positions_and_q(cuda, shape, aligned):
    """Q from 1 to 32 (empty and full-row ROIs, lv == uv among them), with
    and without positions (repeated, unsorted, empty; on the card and as
    host arrays staged with the flags), on aligned and misaligned planes;
    one launch a call with anything to count."""
    words, rois = _packed_inputs(shape, 41, cuda)
    if not aligned:
        words = _misaligned(words)
    n, h, _ = shape
    nw = words.shape[2]
    for kind in POSITIONS:
        pos = _pos(kind, n, cuda)
        b = n if pos is None else len(pos)
        for q in MULTI_QS + (0,):
            rois_q, lvs, uvs = _multi_case(rois, q, h, nw)
            rois_q = rois_q if pos is None else rois_q[:, pos]
            want = ref.cp_count_multi_packed_ref(words, rois_q, lvs, uvs, pos)
            before = ops.cp_count_multi_packed.launches
            _eq(ops.cp_count_multi_packed(words, rois_q, lvs, uvs, pos), want)
            assert ops.cp_count_multi_packed.launches == before + (b * q > 0)
            host_pos = None if pos is None else pos.cpu().numpy()
            _eq(ops.cp_count_multi_packed(words, rois_q.cpu().numpy(), lvs,
                                          uvs, host_pos), want)


def _fused_pass_rois(boxes, h, w):
    """The scheduler pass's 8 descriptors over masks with object boxes
    ``boxes`` (chip_smoke.py's ``fused_specs``): per-mask boxes, full image
    twice, an off-grid box, the boxes again, a word column, a row band and
    an empty ROI."""
    b = len(boxes)

    def const(r):
        return np.tile(np.asarray(r, np.int32), (b, 1))

    full = const([0, 0, h, w])
    rois_q = np.stack([boxes, full, full, const([3, 5, h - 3, w - 1]),
                       boxes, const([0, 32, h, 64]),
                       const([h // 2 - 12, 0, h // 2 + 38, w]),
                       const([10, 10, 10, 100])]).astype(np.int32)
    lvs = np.float32([0.5, 0.5, -0.5, 0.5, 0.0, 0.5, 1.0, 0.5])
    uvs = np.float32([1.5, 1.5, 0.5, 1.5, 1.0, 3.4e38, 1.5, 1.5])
    return rois_q, lvs, uvs


@pytest.mark.parametrize("b", [1, 7, 708, 4096])
def test_cp_multi_packed_kernel_batch_sizes(cuda, b):
    """B from one mask to 4,096 positions (with repeats) over a resident
    224x224 array, Q = 8 as in the scheduler's fused pass: indexed with
    host and with card positions, and the same batch gathered (every block
    writes its entries once into an output that is never zeroed)."""
    from repro_torch.core.packing import pack_masks
    n, h, w = 300, 224, 224
    rng = np.random.default_rng(b + 1)
    words = torch.from_numpy(pack_masks(rng.random((n, h, w)) < 0.4).view(
        np.int32)).to(cuda)
    pos = rng.integers(0, n, b)
    rois_q, lvs, uvs = _fused_pass_rois(object_boxes(b, h, w, seed=b), h, w)
    want = ref.cp_count_multi_packed_ref(words, rois_q, lvs, uvs, pos)
    _eq(ops.cp_count_multi_packed(words, rois_q, lvs, uvs, pos), want)
    pos_d = torch.from_numpy(pos).to(cuda)
    _eq(ops.cp_count_multi_packed(words, torch.from_numpy(rois_q).to(cuda),
                                  lvs, uvs, pos_d), want)
    _eq(ops.cp_count_multi_packed(words[pos_d].contiguous(), rois_q, lvs,
                                  uvs), want)


@pytest.mark.parametrize("aligned", [True, False])
def test_cp_multi_packed_kernel_planes_past_shared_memory(cuda, aligned):
    """Planes over 48 KB (400 rows of 35 words) are counted from device
    memory directly, with and without positions."""
    words, rois = _packed_inputs((3, 400, 1100), 43, cuda)
    if not aligned:
        words = _misaligned(words)
    rois_q, lvs, uvs = _multi_case(rois, 9, 400, words.shape[2])
    for kind in POSITIONS:
        pos = _pos(kind, 3, cuda)
        rq = rois_q if pos is None else rois_q[:, pos]
        _eq(ops.cp_count_multi_packed(words, rq, lvs, uvs, pos),
            ref.cp_count_multi_packed_ref(words, rq, lvs, uvs, pos))


@pytest.mark.parametrize("bad", [-1, 5])
def test_cp_multi_packed_position_out_of_range_traps(cuda, bad):
    """A position outside [0, N) traps the kernel, as an index out of range
    asserts: the launch's stream reports an error instead of counting some
    other memory.  A trap spoils the process's CUDA context, so the call
    runs in a child process."""
    code = textwrap.dedent(f"""
        import os
        import numpy as np
        import torch
        from repro_torch.kernels import ops
        words = torch.zeros((5, 8, 2), dtype=torch.int32, device="cuda")
        rois = np.tile(np.int32([0, 0, 8, 64]), (1, 2, 1))
        ops.cp_count_multi_packed(words, rois, [0.5], [1.5], [0, 4])
        torch.cuda.synchronize()
        print("in range: counted", flush=True)
        try:
            ops.cp_count_multi_packed(words, rois, [0.5], [1.5], [0, {bad}])
            torch.cuda.synchronize()
        except RuntimeError as err:
            print("out of range: trapped,", err, flush=True)
            os._exit(3)
        print("out of range: no error", flush=True)
        os._exit(0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "in range: counted" in out.stdout, out.stdout + out.stderr
    assert out.returncode == 3, out.stdout + out.stderr
    assert "out of range: trapped" in out.stdout


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("shape", PACKED_SHAPES)
def test_pair_packed_kernel_positions(cuda, shape, aligned):
    """Each role read in place through its positions (repeated, unsorted,
    empty; one role indexed, the other as given), on aligned and
    misaligned planes."""
    a, rois = _packed_inputs(shape, 30, cuda)
    b, _ = _packed_inputs(shape, 31, cuda)
    if not aligned:
        a, b = _misaligned(a), _misaligned(b)
    n = shape[0]
    for kind in POSITIONS[1:]:
        pa = _pos(kind, n, cuda)
        pb = pa.flip(0)
        r = rois[pa.cpu() % n] if len(pa) else rois[:0]
        for ta, tb in ((0.5, 0.5), (-0.5, 1.0), (0.0, -0.5)):
            for got, want in zip(
                    ops.pair_counts_packed(a, b, r, ta, tb, pa, pb),
                    ref.pair_counts_packed_ref(a, b, r, ta, tb, pa, pb)):
                _eq(got, want)
    pa = _pos("unsorted", n, cuda)[:n]
    for got, want in zip(
            ops.pair_counts_packed(a, b, rois, 0.5, 0.5, pa, None),
            ref.pair_counts_packed_ref(a, b, rois, 0.5, 0.5, pa, None)):
        _eq(got, want)


def test_pair_packed_kernel_large_batch(cuda):
    """8,192 object-box pairs over 256 resident 224x224 masks, indexed and
    gathered, at the main path's shape."""
    from repro_torch.core.packing import pack_masks
    n, h, w, b = 256, 224, 224, 8192
    rng = np.random.default_rng(9)
    words = torch.from_numpy(pack_masks(rng.random((n, h, w)) < 0.4).view(
        np.int32)).to(cuda)
    pa = torch.from_numpy(rng.integers(0, n, b)).to(cuda)
    pb = torch.from_numpy(rng.integers(0, n, b)).to(cuda)
    rois = torch.from_numpy(object_boxes(b, h, w, seed=4)).to(cuda)
    want = ref.pair_counts_packed_ref(words, words, rois, 0.6, 0.6, pa, pb)
    for got, wnt in zip(ops.pair_counts_packed(words, words, rois, 0.6, 0.6,
                                               pa, pb), want):
        _eq(got, wnt)
    for got, wnt in zip(ops.pair_counts_packed(words[pa], words[pb], rois,
                                               0.6, 0.6), want):
        _eq(got, wnt)


def test_empty_kernel_launches(cuda):
    from repro_torch.kernels import popcount
    popcount.empty_launch(cuda)
    torch.cuda.synchronize()


def test_popcount_kernels_refuse_other_word_types(cuda):
    m, rois = _packed_inputs((2, 8, 40), 1, cuda)
    with pytest.raises(TypeError):
        ops.cp_count_packed(m.to(torch.float32), rois, 0.5, 1.5)
    with pytest.raises(ValueError):
        ops.cp_count_packed(m[:, :, :1], rois, 0.5, 1.5)   # not contiguous


def test_packed_store_and_queries_match_cpu(cuda):
    n, h, w = 64, 64, 72
    rois = object_boxes(n, h, w, seed=1)
    masks, _ = saliency_masks(n, h, w, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    masks = (masks > 0.5).astype(np.float32)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=h, width=w)
    stores = {}
    for d in ("cpu", cuda):
        s = MaskStore.create_memory(masks[:32], meta[:32], cfg, packed=True,
                                    device=d)
        s.append(masks[32:], meta[32:])
        stores[str(d)] = s
    assert stores["cuda"].device_masks().dtype == torch.int32
    np.testing.assert_array_equal(stores["cuda"].chi_host(),
                                  stores["cpu"].chi_host())
    for sql in ("SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, "
                "(0.5, 1.5)) / AREA(roi) < 0.5;",
                "SELECT mask_id FROM MasksDatabaseView ORDER BY CP(mask, "
                "(3, 5, 61, 69), (0.5, 1.5)) DESC LIMIT 9;",
                queries.SCENARIO3_IOU):
        want, _ = queries.run(sql, stores["cpu"], provided_rois=rois)
        for backend in ("host", "device"):
            got, _ = queries.run(sql, stores["cuda"], provided_rois=rois,
                                 backend=backend)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        scan, _ = queries.run(sql, stores["cuda"], provided_rois=rois,
                              use_index=False)
        np.testing.assert_array_equal(scan[0], want[0])


# -- the query service on the card ---------------------------------------------

def test_service_on_the_card_matches_cpu(cuda):
    """A 64-mask card store and its CPU twin, each behind the async tier;
    4 client threads send the four main queries, a paged session and a
    fused workload to both.  The card store's default backend is the
    device backend, the twin's the host backend: answers must be equal."""
    import threading

    from repro_torch.core import get_backend
    from repro_torch.service import MaskSearchService, ServiceClient
    from repro_torch.service.asyncserver import serve_in_thread
    from repro_torch.service.server import _synthetic_store

    fronts = {}
    for d in ("cpu", "cuda"):
        store, rois = _synthetic_store(64, 64, device=d)
        service = MaskSearchService(store, provided_rois=rois)
        fronts[d] = (service, serve_in_thread(service))
    assert get_backend(fronts["cuda"][0].store, None).name == "device"
    assert fronts["cuda"][0].stats()["backend"] == "device"
    assert fronts["cpu"][0].stats()["backend"] == "host"
    topk = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
            "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 4;")
    sqls = ["SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.02;",
            queries.SCENARIO1_TOPK, queries.SCENARIO2_TOPK,
            queries.SCENARIO3_IOU]
    workload = ["SELECT mask_id FROM MasksDatabaseView ORDER BY "
                f"CP(mask, full_img, ({lv}, {lv + 0.4})) DESC LIMIT 9;"
                for lv in (0.1, 0.15, 0.2, 0.25)]

    def client_work(base, out, i):
        c = ServiceClient(base, timeout=120)
        got = [(r.get("ids"), r.get("scores"))
               for r in (c.query(sql) for sql in sqls)]
        sess = c.query(topk, session=True, page_size=4)
        pages = [sess["page"]["ids"]]
        for _ in range(2):
            sess = c.next_page(sess["session"])
            pages.append(sess["page"]["ids"])
        got.append(pages)
        got.append([(r["ids"], r["scores"]) for r in c.workload(workload)])
        out[i] = got

    answers = {}
    try:
        for d, (_, handle) in fronts.items():
            out: dict = {}
            threads = [threading.Thread(target=client_work,
                                        args=(handle.base_url, out, i))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert len(out) == 4, f"{d}: a client thread failed"
            answers[d] = out
    finally:
        for service, handle in fronts.values():
            handle.stop()
            service.close()
    for i in range(4):
        assert answers["cuda"][i] == answers["cpu"][i]
        assert answers["cuda"][i] == answers["cuda"][0]
    assert fronts["cuda"][0].scheduler.stats.fused_passes > 0


# -- the mesh on the card ------------------------------------------------------

def _twin_stores(packed, cuda):
    """A 64-mask store on the card and its CPU twin (32 saliency/attention
    pairs: types 1 and 2 alternate per image)."""
    n, h, w = 64, 64, 64
    rois = object_boxes(n, h, w, seed=1)
    masks, _ = saliency_masks(n, h, w, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    if packed:
        masks = (masks > 0.5).astype(np.float32)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=h, width=w)
    return {str(d): MaskStore.create_memory(masks, meta, cfg, packed=packed,
                                            device=d)
            for d in ("cpu", cuda)}, rois


MESH_SQL = {
    False: ["SELECT mask_id FROM MasksDatabaseView WHERE "
            "CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.02;",
            queries.SCENARIO1_TOPK, queries.SCENARIO3_IOU,
            "SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, "
            "(0.8, 1.0)) > 50 AND NOT CP(mask, full_img, (0.2, 0.6)) < 100 "
            "ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 10;"],
    True: ["SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, "
           "(0.5, 1.5)) / AREA(roi) < 0.2;",
           "SELECT mask_id FROM MasksDatabaseView ORDER BY CP(mask, "
           "(3, 5, 61, 59), (0.5, 1.5)) DESC LIMIT 9;",
           queries.SCENARIO3_IOU],
}
MESH_PAIR_SQL = [
    queries.SCENARIO6_DISCREPANCY,
    "SELECT image_id FROM MasksDatabaseView WHERE "
    "PAIR_DIFF(saliency, attention, 0.6, 0.6, roi) > 20;"]
MESH_KERNELS = {
    False: ("cp_count", "cp_count_multi", "mask_agg_counts", "pair_counts"),
    True: ("fused_bounds_verify", "cp_count_multi_packed",
           "mask_agg_counts_packed", "pair_counts_packed"),
}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shards", [1, 4, "cards"])
def test_mesh_on_the_card_matches_cpu(cuda, shards, packed):
    """A card store on a mesh of ``cuda:0`` (one shard, or four logical
    shards) or of every visible card (``"cards"``: the default mesh, one
    shard a card, results gathered on ``cuda:0``) answers as its CPU twin's
    host and mesh backends, with equal ``ExecStats``, and launches the CUDA
    kernels (once per shard)."""
    from repro_torch.core import MeshBackend, get_backend
    from repro_torch.core.distributed import make_mesh

    stores, rois = _twin_stores(packed, cuda)
    if shards == "cards":
        mesh = make_mesh((torch.cuda.device_count(),), ("data",))
        shards = mesh.size
    else:
        mesh = make_mesh((shards,), ("data",), ["cuda:0"] * shards)
    be = MeshBackend(stores["cuda"], mesh)
    twin = MeshBackend(stores["cpu"],
                       make_mesh((shards,), ("data",), ["cpu"] * shards))
    ops.reset_launches()
    for sql in MESH_SQL[packed] + MESH_PAIR_SQL:
        want, wst = queries.run(sql, stores["cpu"], provided_rois=rois,
                                backend="host")
        twin_ans, tst = queries.run(sql, stores["cpu"], provided_rois=rois,
                                    backend=twin)
        got, gst = queries.run(sql, stores["cuda"], provided_rois=rois,
                               backend=be)
        for a in (want, twin_ans):
            if isinstance(a, tuple):
                np.testing.assert_array_equal(got[0], a[0])
                np.testing.assert_array_equal(got[1], a[1])
            else:
                np.testing.assert_array_equal(got, a)
        assert gst.n_verified == wst.n_verified > 0
        assert gst == dataclasses.replace(
            tst, bound_time_s=gst.bound_time_s,
            verify_time_s=gst.verify_time_s)
    pos = np.arange(0, 64, 3)
    specs = [(rois[pos], 0.5, 1.5), (np.tile([0, 0, 64, 64], (len(pos), 1)),
                                     0.2, 0.6)]
    np.testing.assert_array_equal(be.fused_counts(stores["cuda"], pos, specs),
                                  get_backend(stores["cpu"], "host")
                                  .fused_counts(stores["cpu"], pos, specs))
    counts = ops.launch_counts()
    for k in MESH_KERNELS[packed]:
        assert counts[k] > 0 and counts[k] % shards == 0, (k, counts)
    assert mesh.placed_bytes > 0


def test_mesh_refuses_cpu_shards_for_a_card_store(cuda):
    from repro_torch.core import MeshBackend, get_backend
    from repro_torch.core.distributed import make_mesh
    stores, _ = _twin_stores(False, cuda)
    with pytest.raises(ValueError):
        MeshBackend(stores["cuda"], make_mesh((2,), ("data",), ["cpu"] * 2))
    be = get_backend(stores["cuda"], "mesh")
    assert be.mesh.devices == tuple(
        torch.device("cuda", i) for i in range(torch.cuda.device_count()))


# ---------------------------------------------------------------------------
# the mask producers: granite SMOKE and the saliency functions on the card
# ---------------------------------------------------------------------------


def _granite_twins(cuda, dtype="float32"):
    """granite SMOKE on the CPU (random init, generator seed 0, ``wq`` and
    ``wk`` scaled by 1/4 as in the CPU tests: at the init's scale the
    softmax is near an argmax and a GEMM's summation order decides it)
    and the same weights on the card."""
    from repro_torch.configs import load_smoke
    from repro_torch.models import build_model
    cfg = dataclasses.replace(load_smoke("granite_3_2b"), dtype=dtype)
    cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for blk in cpu.blocks:
            blk.mixer.wq.mul_(0.25)
            blk.mixer.wk.mul_(0.25)
    card = build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def test_granite_smoke_on_the_card_matches_cpu(cuda, no_tf32):
    """Logits, attention maps, prefill and greedy decode in float32: the
    card's answers within 1e-3 (logits) and 1e-5 (probabilities) of the
    CPU's, TF32 off."""
    from repro_torch.launch import serve
    cpu, card = _granite_twins(cuda)
    batch = serve.prompt_batch(cpu.cfg, 4, 48)
    with torch.no_grad():
        for fn, atol in (("logits", 1e-3), ("attention_maps", 1e-5)):
            want = getattr(cpu, fn)(batch)
            got = getattr(card, fn)(batch)
            if fn == "logits":
                want, got = want[0], got[0]
            assert got.device.type == cuda.type
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)
    want = serve.greedy_generate(cpu, batch, 6)
    got = serve.greedy_generate(card, batch, 6)
    assert got["finite"] and torch.equal(got["tokens"].cpu(), want["tokens"])


def test_saliency_and_augment_on_the_card_match_cpu(cuda, no_tf32):
    from repro_torch.core import augment, saliency
    from repro_torch.models.layers import (cross_entropy, logits_from_tied,
                                           rms_norm)
    rng = np.random.default_rng(0)
    attn = torch.softmax(torch.from_numpy(
        rng.standard_normal((3, 2, 4, 32, 32)).astype(np.float32)), -1)
    scores = torch.from_numpy(rng.random((2, 50)).astype(np.float32))
    for fn, args in ((saliency.attention_rollout, (attn,)),
                     (saliency.last_layer_attention, (attn[-1],)),
                     (saliency.normalize01, (attn[0, 0],)),
                     (saliency.tokens_to_grid, (scores, 8, 8)),
                     (saliency.tokens_to_grid, (scores, 4, 5)),
                     (saliency.resize_mask, (attn[0, 0], 8, 8)),
                     (saliency.resize_mask, (attn[0, 0], 224, 224)),
                     (saliency.expert_utilization_map,
                      (attn[0, 0, :2], 16, 16))):
        want = fn(*args)
        got = fn(*(a.to(cuda) if isinstance(a, torch.Tensor) else a
                   for a in args))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)

    cpu, card = _granite_twins(cuda)
    tokens = rng.integers(0, cpu.cfg.vocab_size, (2, 32))

    def loss_fn(model, batch, emb):
        pos = torch.arange(emb.shape[1], device=emb.device).expand(
            emb.shape[:2])
        x = emb
        for blk in model.blocks:
            x = blk(x, pos)
        h = rms_norm(x, model.final_norm, model.cfg.norm_eps)
        logits = logits_from_tied(model.embedding, h, model.cfg.vocab_size)
        return cross_entropy(logits, batch["labels"])
    sal = {}
    for name, m in (("cpu", cpu), ("card", card)):
        t = torch.as_tensor(tokens, device=m.device)
        sal[name] = saliency.input_saliency(loss_fn, m, {
            "embeddings": m.embedding[t].detach(), "labels": t})
    torch.testing.assert_close(sal["card"].cpu(), sal["cpu"], rtol=1e-4,
                               atol=1e-4)

    imgs = torch.from_numpy(saliency_masks(4, 32, 32, seed=0)[0]).to(cuda)
    rois = torch.from_numpy(object_boxes(4, 32, 32, seed=1)).to(cuda)
    out = augment.randomize_outside_roi(
        torch.Generator(cuda).manual_seed(0), imgs, rois)
    inside = ref._roi_mask(rois, 32, 32)
    assert out.device.type == cuda.type
    assert torch.equal(out[inside], imgs[inside])
    assert bool((out[~inside] != imgs[~inside]).all())
    toks = torch.as_tensor(tokens, device=cuda)
    sel = torch.tensor([True, False], device=cuda)
    mixed = augment.mix_augmented(torch.Generator(cuda).manual_seed(1), toks,
                                  sel, 50)
    assert torch.equal(mixed[1], toks[1]) and bool((mixed[0] < 50).all())


def test_producer_store_query_on_the_card_matches_cpu(cuda, no_tf32):
    """64 attention masks made by granite SMOKE on the card, ingested on the
    card, queried on both backends and as a naive scan: the same masks,
    CHI, answers and ExecStats as the CPU twin's; the ingest and query
    kernels launch."""
    from repro_torch.core import saliency
    from repro_torch.data.pipeline import SyntheticLMData
    cpu, card = _granite_twins(cuda)
    batch = SyntheticLMData(cpu.cfg, 64, 64, seed=0).batch_at(0)
    masks = {"cpu": saliency.last_layer_attention(
        cpu.attention_maps(batch)).numpy()}
    masks["cuda"] = saliency.last_layer_attention(
        card.attention_maps(batch)).cpu().numpy()
    np.testing.assert_allclose(masks["cuda"], masks["cpu"], rtol=0,
                               atol=1e-5)
    meta = np.zeros(64, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(64)
    meta["image_id"] = np.arange(64)
    meta["mask_type"] = 1
    cfg = CHIConfig(grid=16, num_bins=16, height=64, width=64)
    rois = np.tile(np.asarray([0, 16, 64, 48], np.int32), (64, 1))
    ratio = ((masks["cuda"][:, :, 16:48] >= 0.01) & (
        masks["cuda"][:, :, 16:48] < 1.0)).mean(axis=(1, 2))
    cut = float(np.median(ratio))
    sqls = ["SELECT mask_id FROM MasksDatabaseView ORDER BY CP(mask, roi, "
            "(0.5, 1.0)) / AREA(roi) ASC LIMIT 8;",
            "SELECT mask_id FROM MasksDatabaseView ORDER BY CP(mask, roi, "
            "(0.01, 1.0)) / AREA(roi) ASC LIMIT 8;",
            "SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, "
            f"(0.01, 1.0)) / AREA(roi) > {cut!r};"]
    ops.reset_launches()
    stores = {}
    for d in ("cuda", "cpu"):
        stores[d] = MaskStore.create_memory(masks["cuda"][:32], meta[:32],
                                            cfg, device=d)
        stores[d].append(masks["cuda"][32:], meta[32:])
    assert np.array_equal(stores["cuda"].chi_host(), stores["cpu"].chi_host())
    for sql in sqls:
        scan, _ = queries.run(sql, stores["cuda"], provided_rois=rois,
                              use_index=False)
        for be in ("device", "host"):
            want, wst = queries.run(sql, stores["cpu"], provided_rois=rois,
                                    backend=be)
            got, gst = queries.run(sql, stores["cuda"], provided_rois=rois,
                                   backend=be)
            for a in (want, scan):
                if isinstance(a, tuple):
                    np.testing.assert_array_equal(got[0], a[0])
                    np.testing.assert_array_equal(got[1], a[1])
                else:
                    np.testing.assert_array_equal(got, a)
            assert gst == dataclasses.replace(
                wst, bound_time_s=gst.bound_time_s,
                verify_time_s=gst.verify_time_s)
    counts = ops.launch_counts()
    for k in ("chi_cell_hist", "cp_count_multi", "cp_count"):
        assert counts[k] > 0, (k, counts)


# ---------------------------------------------------------------------------
# training: rms_norm's hand-written VJP and a train step on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_vjp_on_the_card_matches_cpu(cuda, dtype):
    """Output, ``dx`` and ``dw`` on the card against the CPU's (rtol = atol
    = 1e-5 of scale in float32, 2e-2 in bf16, as the CPU tests)."""
    from repro_torch.models.layers import rms_norm
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64, 256)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((0.1 * rng.standard_normal(256)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 64, 256)).astype(
        np.float32)).to(dtype)
    out = {}
    for dev in ("cpu", cuda):
        a = x.to(dev).clone().requires_grad_(True)
        b = w.to(dev).clone().requires_grad_(True)
        y = rms_norm(a, b, 1e-6)
        y.backward(g.to(dev))
        out[str(dev)] = [t.detach().cpu().double() for t in (y, a.grad,
                                                             b.grad)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in zip(out[str(cuda)], out["cpu"]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


def test_train_step_on_the_card_matches_cpu(cuda, no_tf32):
    """One train step of granite SMOKE in float32 (two microbatches) on the
    card and on the CPU from the same weights: loss within 1e-5 relative,
    grad norm within 1e-4, and the updated params within the CPU tests'
    rule (``test_torch_train.close_after_steps``: 1e-5 of scale, and up to
    2.5·lr more where a grad element is under the rounding noise)."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (make_loss_and_grads,
                                              make_train_step)
    cpu, card = _granite_twins(cuda)
    opt_cfg = OptConfig(warmup_steps=2, total_steps=20)
    batch = SyntheticLMData(cpu.cfg, 32, 4).batch_at(0)
    _, _, grads = make_loss_and_grads(cpu, 2)(batch)
    noisy = [g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))
             for g in grads]
    metrics = {}
    for name, m in (("cpu", cpu), ("card", card)):
        opt = init_opt_state(m.parameters(), opt_cfg)
        _, metrics[name] = make_train_step(m, opt_cfg, microbatches=2)(
            opt, batch)
    assert float(metrics["card"]["loss"]) == pytest.approx(
        float(metrics["cpu"]["loss"]), rel=1e-5)
    assert float(metrics["card"]["grad_norm"]) == pytest.approx(
        float(metrics["cpu"]["grad_norm"]), rel=1e-4)
    lr = float(metrics["cpu"]["lr"])
    for (name, p), q, n in zip(card.named_parameters(), cpu.parameters(),
                               noisy):
        got, want = p.detach().cpu().double(), q.detach().double()
        allowed = 1e-5 * max(1.0, float(want.abs().max())) + \
            1e-5 * want.abs() + 2.5 * lr * n
        assert bool(((got - want).abs() <= allowed).all()), name


# ---------------------------------------------------------------------------
# the recurrent and encoder-decoder families on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_13b",
                                  "whisper_large_v3"])
def test_other_families_on_the_card_match_cpu(cuda, no_tf32, arch):
    """Each family's SMOKE config in float32 (generator seed 0, ``wq``/
    ``wk`` at 1/4): logits within 1e-4 of their scale, the family's mask
    source (recurrentgemma's last local layer's attention maps, mamba2's
    input saliency, whisper's cross maps) within 1e-5 (saliency 1e-4),
    and the greedy tokens of prefill + 5 decode steps equal, card against
    CPU, TF32 off."""
    from repro_torch.configs import load_smoke
    from repro_torch.core import saliency
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import (cross_entropy, logits_from_tied,
                                           rms_norm)
    cfg = dataclasses.replace(load_smoke(arch), dtype="float32")
    cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith(("wq", "wk")):
                p.mul_(0.25)
    card = build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    batch = serve.prompt_batch(cfg, 2, 24, seed=3)

    def loss_fn(m, b, emb):
        pos = torch.arange(emb.shape[1], device=emb.device).expand(
            emb.shape[:2])
        x = emb
        for blk in m.blocks:
            x = blk(x, pos)
        h = rms_norm(x, m.final_norm, m.cfg.norm_eps)
        return cross_entropy(logits_from_tied(m.embedding, h,
                                              m.cfg.vocab_size),
                             torch.as_tensor(b["labels"], device=emb.device))

    def outputs(m):
        with torch.no_grad():
            if cfg.is_encoder_decoder:
                h = m._decoder(batch["tokens"], m.encode(batch["audio_feats"]))
                logits = logits_from_tied(m.embedding, h, cfg.vocab_size)
                maps = m.cross_attention_maps(batch)
            else:
                logits = m.logits(batch)[0]
                maps = m.attention_maps(batch)
        if maps is None:
            t = torch.as_tensor(batch["tokens"], device=m.device).long()
            maps = saliency.input_saliency(loss_fn, m, {
                "labels": np.roll(batch["tokens"], -1, axis=1),
                "embeddings": m.embedding[t]})
            assert float(maps.max()) > 0
        return logits, maps
    want, got = outputs(cpu), outputs(card)
    assert got[0].device.type == cuda.type
    v = cfg.vocab_size                          # past it, pad columns
    scale = max(1.0, float(want[0][..., :v].abs().max()))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0,
                               atol=1e-4 * scale)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0,
                               atol=1e-4 if arch == "mamba2_13b" else 1e-5)
    want = serve.greedy_generate(cpu, batch, 6)
    got = serve.greedy_generate(card, batch, 6)
    assert got["finite"] and torch.equal(got["tokens"].cpu(), want["tokens"])


# ---------------------------------------------------------------------------
# the DeepSeek family on the card
# ---------------------------------------------------------------------------


def _deepseek_twins(cuda, arch="deepseek_v2_236b", **overrides):
    """A SMOKE model in float32 on the CPU (generator seed 0) and its copy
    on the card."""
    from repro_torch.configs import load_smoke
    from repro_torch.models import build_model
    cfg = dataclasses.replace(load_smoke(arch), dtype="float32", **overrides)
    cpu = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    card = build_model(cfg, cuda)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _close(got, want, tol):
    """``got`` (on the card) within ``tol`` of ``want``'s scale."""
    want = want.detach().double()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.detach().cpu().double(), want, rtol=0,
                               atol=tol * scale)


@pytest.mark.parametrize("factor", [1.25, 100.0])
def test_moe_ffn_on_the_card_matches_cpu(cuda, no_tf32, factor):
    """deepseek-v2 SMOKE's first MoE layer, 4 x 32 tokens, at the configs'
    capacity factor (assignments drop) and at 100: output, aux and the
    gradients into the input and every weight within 1e-5 of scale, card
    against CPU, TF32 off."""
    from repro_torch.models import moe
    cpu, card = _deepseek_twins(cuda, capacity_factor=factor)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 32, cpu.cfg.d_model)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        x.shape).astype(np.float32))
    outs = {}
    for name, m in (("cpu", cpu), ("card", card)):
        xi = x.to(m.device).detach().requires_grad_(True)
        y, aux = moe.moe_ffn(m.blocks[1].ffn, m.cfg, xi)
        torch.autograd.backward((y, aux), (g.to(m.device),
                                           torch.tensor(3.0, device=m.device)))
        outs[name] = [y, aux, xi.grad] + [p.grad for p in
                                          m.blocks[1].ffn.parameters()]
    assert outs["card"][0].device.type == cuda.type
    for got, want in zip(outs["card"], outs["cpu"]):
        _close(got, want, 1e-5)


def test_mla_decode_on_the_card_matches_cpu(cuda, no_tf32):
    """MLA on deepseek-v2 SMOKE's layer 0: prefill of 12 positions into the
    compressed cache, then 4 absorbed decode steps, each output and cache
    within 1e-5 of scale, card against CPU, TF32 off."""
    from repro_torch.models import mla
    cpu, card = _deepseek_twins(cuda)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, cpu.cfg.d_model)).astype(np.float32))
    outs = {}
    with torch.no_grad():
        for name, m in (("cpu", cpu), ("card", card)):
            p, cfg, dev = m.blocks[0].mixer, m.cfg, m.device
            xd = x.to(dev)
            cache = mla.init_mla_cache(cfg, 2, 24, torch.float32, dev)
            pos = torch.arange(12, device=dev).expand(2, -1)
            o, cache = mla.mla_prefill(p, cfg, xd[:, :12], pos, cache)
            outs[name] = [o]
            for step in range(12, 16):
                o, cache = mla.mla_decode(p, cfg, xd[:, step:step + 1], step,
                                          cache)
                outs[name] += [o, cache["ckv"].clone(), cache["kpe"].clone()]
    for got, want in zip(outs["card"], outs["cpu"]):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "deepseek_v3_671b"])
def test_deepseek_smoke_on_the_card_matches_cpu(cuda, no_tf32, arch):
    """deepseek-v2 and -v3 SMOKE in float32: logits (1e-4 of scale), the
    router probabilities of the expert-utilisation masks (1e-5), the loss
    with ``labels_mtp`` (1e-5 relative), the greedy tokens of prefill + 5
    decode steps, then one train step in 2 microbatches (loss 1e-5
    relative, params within ``test_train_step_on_the_card_matches_cpu``'s
    rule), card against CPU, TF32 off."""
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (make_loss_and_grads,
                                              make_train_step)
    cpu, card = _deepseek_twins(cuda, arch)
    batch = SyntheticLMData(cpu.cfg, 32, 4).batch_at(0)
    v = cpu.cfg.vocab_size
    with torch.no_grad():
        _close(card.logits(batch)[0][..., :v], cpu.logits(batch)[0][..., :v],
               1e-4)
        _close(card.router_probs(batch), cpu.router_probs(batch), 1e-5)
        got, want = card.loss(batch)[1], cpu.loss(batch)[1]
    assert set(got) == set(want) == ({"ce", "aux", "loss"} |
                                     ({"ce_mtp"} if cpu.cfg.mtp_depth
                                      else set()))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    prompt = serve.prompt_batch(cpu.cfg, 2, 16, seed=3)
    want = serve.greedy_generate(cpu, prompt, 6)
    got = serve.greedy_generate(card, prompt, 6)
    assert got["finite"] and torch.equal(got["tokens"].cpu(), want["tokens"])
    opt_cfg = OptConfig(warmup_steps=2, total_steps=20)
    _, _, grads = make_loss_and_grads(cpu, 2)(batch)
    noisy = [g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))
             for g in grads]
    metrics = {}
    for name, m in (("cpu", cpu), ("card", card)):
        opt = init_opt_state(m.parameters(), opt_cfg)
        _, metrics[name] = make_train_step(m, opt_cfg, microbatches=2)(
            opt, batch)
    assert float(metrics["card"]["loss"]) == pytest.approx(
        float(metrics["cpu"]["loss"]), rel=1e-5)
    lr = float(metrics["cpu"]["lr"])
    for (name, p), q, n in zip(card.named_parameters(), cpu.parameters(),
                               noisy):
        got, want = p.detach().cpu().double(), q.detach().double()
        allowed = 1e-5 * max(1.0, float(want.abs().max())) + \
            1e-5 * want.abs() + 2.5 * lr * n
        assert bool(((got - want).abs() <= allowed).all()), name
