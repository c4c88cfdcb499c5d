"""PyTorch port: plain kernel versions vs the JAX package's kernels.

Every port kernel wrapper, on a CPU tensor, runs its plain PyTorch version
(``repro_torch.kernels.ref``); these tests hold those against the JAX
package's jnp references and its Pallas kernels in interpret mode, on the
same numpy inputs.  Every output is an int32 count, so agreement is exact
equality.  Inputs come from fixed numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.chi_build import chi_cell_hist_pallas
from repro.kernels.cp_count import cp_count_multi_pallas, cp_count_pallas
from repro.kernels.mask_agg import mask_agg_counts_pallas
from repro_torch.kernels import cuda_lib, ops, ref
from repro_torch.kernels.cp_count import thresholds

SHAPES = [(3, 64, 64), (2, 128, 256), (5, 96, 160), (1, 256, 256), (4, 32, 512)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _random(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _random_rois(b, h, w, seed=1):
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
    c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
    return np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1).astype(np.int32)


def _pair(m, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    return jnp.asarray(m, jdt), torch.from_numpy(m).to(tdt)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cp_count_matches_jax(shape, dtype):
    b, h, w = shape
    jm, tm = _pair(_random(shape), dtype)
    rois = _random_rois(b, h, w)
    got = ops.cp_count(tm, torch.from_numpy(rois), 0.25, 0.8)
    assert got.dtype == torch.int32 and got.shape == (b,)
    jdt = DTYPES[dtype][0]
    _eq(got, jref.cp_count_ref(jm, jnp.asarray(rois), jnp.asarray(0.25, jdt),
                               jnp.asarray(0.8, jdt)))
    _eq(got, cp_count_pallas(jm, jnp.asarray(rois), 0.25, 0.8,
                             interpret=True))


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_cp_count_full_roi_and_extremes(shape):
    b, h, w = shape
    tm = torch.from_numpy(_random(shape, seed=7))
    full = torch.tensor([[0, 0, h, w]], dtype=torch.int32).repeat(b, 1)
    _eq(ops.cp_count(tm, full, 0.0, 1.0), np.full(b, h * w))
    empty = torch.tensor([[5, 5, 5, w]], dtype=torch.int32).repeat(b, 1)
    _eq(ops.cp_count(tm, empty, 0.0, 1.0), np.zeros(b))
    _eq(ops.cp_count(tm, full, 0.5, 0.5), np.zeros(b))


def test_cp_count_compares_in_mask_dtype():
    """lv/uv round to the mask dtype before the compare, as the Pallas
    wrapper casts them: bf16 0.80078125 counts against lv = 0.802 (which
    rounds to 0.80078125), f32(0.7) counts against lv = 0.7."""
    roi = np.array([[0, 0, 1, 1]], np.int32)
    for value, lv, uv, dtype in ((0.80078125, 0.802, 1.0, "bfloat16"),
                                 (0.7, 0.7, 1.0, "float32")):
        m = np.full((1, 1, 1), value, np.float32)
        jm, tm = _pair(m, dtype)
        got = ops.cp_count(tm, torch.from_numpy(roi), lv, uv)
        _eq(got, [1])
        _eq(got, cp_count_pallas(jm, jnp.asarray(roi), lv, uv,
                                 interpret=True))


@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_cp_count_multi_matches_jax(q, shape):
    b, h, w = shape
    m = _random(shape, seed=3)
    rng = np.random.default_rng(4)
    rois = np.stack([_random_rois(b, h, w, seed=10 + i) for i in range(q)])
    bounds = np.sort(rng.random((q, 2)), axis=1).astype(np.float32)
    got = ops.cp_count_multi(torch.from_numpy(m), torch.from_numpy(rois),
                             bounds[:, 0], bounds[:, 1])
    assert got.shape == (q, b) and got.dtype == torch.int32
    _eq(got, jref.cp_count_multi_ref(jnp.asarray(m), jnp.asarray(rois),
                                     jnp.asarray(bounds[:, 0]),
                                     jnp.asarray(bounds[:, 1])))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cp_count_multi_matches_pallas(dtype):
    b, h, w = SHAPES[2]
    jm, tm = _pair(_random((b, h, w), seed=5), dtype)
    rois = np.stack([_random_rois(b, h, w, seed=20 + i) for i in range(3)])
    lvs = np.array([0.25, 0.5, 0.1], np.float32)
    uvs = np.array([0.8, 0.5, 3.4e38], np.float32)
    got = ops.cp_count_multi(tm, torch.from_numpy(rois), lvs, uvs)
    _eq(got, cp_count_multi_pallas(jm, jnp.asarray(rois), jnp.asarray(lvs),
                                   jnp.asarray(uvs), interpret=True))


POSITIONS = {"unsorted": [4, 0, 2, 5, 1], "repeated": [3, 3, 0, 5, 3, 0, 0],
             "empty": []}


@pytest.mark.parametrize("kind", list(POSITIONS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cp_count_multi_positions_match_jax_on_gathered_batch(dtype, kind):
    """Indexed reads: ``positions`` over the leading axis answer exactly
    what the JAX package answers on the gathered batch ``masks[pos]``."""
    n, h, w = 6, 40, 52
    jm, tm = _pair(_random((n, h, w), seed=31), dtype)
    pos = np.asarray(POSITIONS[kind], np.int64)
    rois = np.stack([_random_rois(len(pos), h, w, seed=32 + i)
                     for i in range(3)])
    rois[1, :] = [2, 3, h, 45]       # columns start and end inside a chunk
    lvs = np.array([0.25, 0.802, 0.1], np.float32)
    uvs = np.array([0.8, 1.0, 3.4e38], np.float32)
    got = ops.cp_count_multi(tm, torch.from_numpy(rois), lvs, uvs,
                             torch.from_numpy(pos))
    assert got.shape == (3, len(pos)) and got.dtype == torch.int32
    jdt = DTYPES[dtype][0]
    want = jops.cp_count_multi(jm[jnp.asarray(pos)], jnp.asarray(rois),
                               jnp.asarray(lvs, jdt), jnp.asarray(uvs, jdt))
    _eq(got, want)
    _eq(ops.cp_count_multi(tm, rois, lvs, uvs, positions=pos.tolist()), want)
    if len(pos):
        _eq(got, cp_count_multi_pallas(
            jm[jnp.asarray(pos)], jnp.asarray(rois), jnp.asarray(lvs),
            jnp.asarray(uvs), interpret=True))


@pytest.mark.parametrize("q", [1, 2, 4, 5, 8, 9, 17])
def test_cp_count_multi_positions_every_descriptor_count(q):
    """Q in each of the kernel's register buckets (1, 2, 4, 8) and above
    the largest, through positions, against the JAX reference."""
    n, h, w = 5, 24, 33
    m = _random((n, h, w), seed=40 + q)
    pos = np.array([4, 1, 1, 0, 3, 2, 4], np.int64)
    rois = np.stack([_random_rois(len(pos), h, w, seed=50 + i)
                     for i in range(q)])
    bounds = np.sort(np.random.default_rng(q).random((q, 2)),
                     axis=1).astype(np.float32)
    got = ops.cp_count_multi(torch.from_numpy(m), torch.from_numpy(rois),
                             bounds[:, 0], bounds[:, 1], torch.from_numpy(pos))
    _eq(got, jref.cp_count_multi_ref(jnp.asarray(m[pos]), jnp.asarray(rois),
                                     jnp.asarray(bounds[:, 0]),
                                     jnp.asarray(bounds[:, 1])))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cp_count_multi_thresholds_round_like_the_plain_version(dtype):
    """The CUDA wrapper rounds lv/uv to the mask dtype on the host; the
    values are the plain version's (and the Pallas wrapper's casts)."""
    tdt = DTYPES[dtype][1]
    lvs = [0.802, 0.7, 0.1, -0.3]
    uvs = np.array([1.0, 0.80078125, 3.4e38, 0.5], np.float32)
    thr = thresholds(lvs, torch.from_numpy(uvs), tdt)
    assert thr.dtype == torch.float32 and thr.shape == (4, 2)
    assert thr.device.type == "cpu"
    _eq(thr[:, 0], torch.as_tensor(lvs).to(tdt).float())
    _eq(thr[:, 1], torch.from_numpy(uvs).to(tdt).float())
    _eq(thr[:, 0], np.asarray(jnp.asarray(np.float32(lvs)).astype(
        DTYPES[dtype][0]).astype(jnp.float32)))
    with pytest.raises(ValueError):
        thresholds([0.1, 0.2], [0.5], tdt)


@pytest.mark.parametrize("shape,grid", [((2, 14, 42), 7), ((3, 16, 36), 4),
                                        ((1, 30, 90), 15)])
@pytest.mark.parametrize("kind", ["binary", "one_bin", "edges"])
def test_chi_cell_hist_odd_widths_and_few_bins_match_jax(shape, grid, kind):
    """Rows whose width is not a multiple of 4 (the kernel's element path)
    and masks whose pixels fall in one or two bins, against the JAX
    reference and its Pallas kernel."""
    m = _random(shape, seed=60)
    if kind == "binary":
        m = (m > 0.5).astype(np.float32)
    elif kind == "one_bin":
        m = np.full(shape, 0.40625, np.float32)
    else:
        m = (np.floor(m * 17) / 16).astype(np.float32)   # on the edges
    edges = (np.arange(1, 16) / 16).astype(np.float32)
    got = ops.chi_cell_hist(torch.from_numpy(m), torch.from_numpy(edges),
                            grid)
    _eq(got, jref.chi_cell_hist_ref(jnp.asarray(m), jnp.asarray(edges), grid))
    _eq(got, chi_cell_hist_pallas(jnp.asarray(m), jnp.asarray(edges), grid,
                                  interpret=True))


@pytest.mark.parametrize("shape,grid", [((2, 64, 64), 8), ((3, 128, 256), 16),
                                        ((1, 256, 256), 16), ((2, 96, 96), 4)])
@pytest.mark.parametrize("nb", [4, 16])
def test_chi_cell_hist_matches_jax(shape, grid, nb):
    m = _random(shape, seed=5)
    edges = (np.arange(1, nb) / nb).astype(np.float32)
    got = ops.chi_cell_hist(torch.from_numpy(m), torch.from_numpy(edges),
                            grid)
    _eq(got, jref.chi_cell_hist_ref(jnp.asarray(m), jnp.asarray(edges), grid))
    _eq(got, chi_cell_hist_pallas(jnp.asarray(m), jnp.asarray(edges), grid,
                                  interpret=True))
    assert int(got.sum()) == int(np.prod(shape))


@pytest.mark.parametrize("shape,grid", [((2, 50, 70), 16), ((3, 33, 64), 8),
                                        ((1, 20, 20), 7), ((2, 5, 9), 16)])
def test_chi_cell_hist_ragged_grid_and_bin_edges(shape, grid):
    """G ∤ H / G ∤ W (and G > H) with pixels exactly on bin edges: the
    plain version bins as core.chi's jnp path and build_chi_np do."""
    from repro.core import chi as jchi
    b, h, w = shape
    rng = np.random.default_rng(17)
    m = _random(shape, seed=16)
    pick = rng.random(shape) < 0.4
    m[pick] = (rng.integers(0, 9, pick.sum()) / 8).astype(np.float32)
    cfg = jchi.CHIConfig(grid=grid, num_bins=8, height=h, width=w)
    got = ops.chi_cell_hist(torch.from_numpy(m),
                            torch.from_numpy(cfg.interior_edges), grid)
    _eq(got, jchi.cell_histograms(jnp.asarray(m), cfg))
    table = np.asarray(jchi.histograms_to_table(jnp.asarray(got.numpy())))
    _eq(table, jchi.build_chi_np(m, cfg))


@pytest.mark.parametrize("s", [2, 3, 5])
@pytest.mark.parametrize("shape", [(4, 64, 64), (2, 128, 128)])
def test_mask_agg_matches_jax(s, shape):
    n, h, w = shape
    m = _random((n, s, h, w), seed=8)
    rois = _random_rois(n, h, w, seed=9)
    gi, gu = ops.mask_agg_counts(torch.from_numpy(m), torch.from_numpy(rois),
                                 0.6)
    wi, wu = jref.mask_agg_counts_ref(jnp.asarray(m), jnp.asarray(rois), 0.6)
    _eq(gi, wi)
    _eq(gu, wu)
    pi, pu = mask_agg_counts_pallas(jnp.asarray(m), jnp.asarray(rois), 0.6,
                                    interpret=True)
    _eq(gi, pi)
    _eq(gu, pu)


def test_mask_agg_bf16_and_empty_roi():
    n, s, h, w = 3, 2, 32, 48
    m = _random((n, s, h, w), seed=30)
    rois = _random_rois(n, h, w, seed=31)
    rois[1, 2] = rois[1, 0]                     # empty ROI
    jm, tm = _pair(m, "bfloat16")
    gi, gu = ops.mask_agg_counts(tm, torch.from_numpy(rois), 0.5)
    wi, wu = jref.mask_agg_counts_ref(jm, jnp.asarray(rois),
                                      jnp.asarray(0.5, jnp.bfloat16))
    _eq(gi, wi)
    _eq(gu, wu)
    assert int(gi[1]) == int(gu[1]) == 0


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_cp_exact_matches_jax(shape):
    """core.cp's exact paths: per-mask (B,) thresholds and (Q, 4) ROIs
    broadcast over the batch, as the JAX cp_exact/cp_exact_multi take."""
    from repro.core import cp as jcp
    from repro_torch.core import cp as tcp
    b, h, w = shape
    m = _random(shape, seed=21)
    rois = _random_rois(b, h, w, seed=22)
    lv = np.linspace(0.1, 0.5, b).astype(np.float32)
    got = tcp.cp_exact(torch.from_numpy(m), rois, lv, 0.9)
    _eq(got, jcp.cp_exact(jnp.asarray(m), jnp.asarray(rois), jnp.asarray(lv),
                          0.9))
    rois_q = rois[:2] if b >= 2 else np.concatenate([rois, rois])
    lvs = np.array([0.2, 0.6], np.float32)
    uvs = np.array([0.7, np.inf], np.float32)
    got = tcp.cp_exact_multi(torch.from_numpy(m), rois_q, lvs, uvs)
    _eq(got, jcp.cp_exact_multi(jnp.asarray(m), jnp.asarray(rois_q),
                                jnp.asarray(lvs), jnp.asarray(uvs)))


def test_cpu_dispatch_counts_no_launch_and_other_devices_raise():
    """A CPU tensor runs the plain version and moves no launch counter; a
    tensor on any other non-CUDA device raises instead of falling back."""
    ops.reset_launches()
    m = torch.from_numpy(_random((2, 16, 16), seed=40))
    rois = torch.tensor([[0, 0, 16, 16], [2, 3, 9, 11]], dtype=torch.int32)
    ops.cp_count(m, rois, 0.1, 0.9)
    ops.cp_count_multi(m, rois[None], [0.1], [0.9])
    ops.chi_cell_hist(m, torch.tensor([0.5]), 4)
    ops.mask_agg_counts(m[None], rois[:1], 0.5)
    assert ops.launch_counts() == {k.name: 0 for k in ops.KERNELS}
    with pytest.raises(ValueError):
        ops.cp_count(m.to("meta"), rois, 0.1, 0.9)


def test_cuda_wrappers_reject_cpu_tensors():
    """The CUDA launch functions take only contiguous CUDA tensors — the
    dispatching wrapper is the one place that picks the plain version."""
    from repro_torch.kernels.cp_count import cp_count_cuda
    m = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError):
        cp_count_cuda(m, torch.zeros((1, 4), dtype=torch.int32), 0.0, 1.0)


def test_kernel_build_is_keyed_on_sources():
    """Libraries are named by a hash of their sources and flags, built into
    the ignored _build directory, one per .cu file; nothing builds on
    import."""
    paths = {name: cuda_lib.library_path(name) for name in cuda_lib.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == cuda_lib.BUILD_DIR
        assert p == cuda_lib.library_path(name)      # deterministic
        assert (cuda_lib.CSRC / f"{name}.cu").exists()
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    names = {k for ks in cuda_lib.SOURCES.values() for k in ks}
    assert names == {k.name for k in ops.KERNELS}
