"""PyTorch port on the card: each CUDA kernel against its plain version.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels build
with ``nvcc`` at first use); elsewhere they skip with a reason.  Run them
on a GPU machine with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs come from fixed numpy seeds; every output is an int32 count, so
kernel and plain version must agree exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.masks import object_boxes, saliency_masks
from repro_torch.core import CHIConfig, MaskStore, queries
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

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
