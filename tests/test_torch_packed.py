"""PyTorch port: the bitpacked binary-mask tier vs the JAX package.

Binary masks (``saliency_masks > 0.5`` from fixed seeds) go into both
packages' packed stores; the port's plain popcount versions, its store
mutations and its packed queries on the host and device backends
(``device="cpu"`` here, so each kernel wrapper runs its plain version) must
equal the JAX package's references, Pallas kernels (interpret mode) and
answers, and the float store holding the same masks.  Every output is an
int32 count or a float64 score built from one, so equality is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CHIConfig as JCfg
from repro.core import MaskStore as JStore
from repro.core import queries as jq
from repro.core.backend import get_backend as jget_backend
from repro.core.packing import pack_masks
from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from repro.kernels import popcount as jpk
from repro_torch.core import CHIConfig as TCfg
from repro_torch.core import MaskStore as TStore
from repro_torch.core import queries as tq
from repro_torch.core.backend import chi_verdicts, get_backend
from repro_torch.core.engine import TopKRun
from repro_torch.core.exprs import (CP, AggCP, BinOp, Cmp, MaskEvalContext,
                                    RoiArea)
from repro_torch.core.plan import LogicalPlan, run_plan
from repro_torch.kernels import ops, ref
from repro_torch.obs.metrics import REGISTRY

# test_packed_properties.py's end-to-end size, plus the tail-bit widths
B, H, W = 24, 32, 32
WIDTHS = (32, 33, 40)
RANGES = ((0.5, 1.5), (0.0, 1.0), (-0.5, 0.5), (-0.5, 1.5), (1.0, 1.5),
          (0.5, 0.5), (0.2, 0.6))
THRESHOLDS = (-0.5, 0.0, 0.5, 1.0, 1.5)
STATS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds",
         "n_dropped_masks", "bytes_loaded", "bytes_saved", "chi_bytes")


def _binary(shape, seed, p=0.4):
    return (np.random.default_rng(seed).random(shape) < p).astype(np.float32)


def _edge_rois(b, h, w, seed):
    """Random ROIs plus the edge cases: unclipped (c1 past W and past the
    last word), empty, negative starts and columns on word edges."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
    c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
    rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
    edges = [(0, 0, h, 64), (3, 5, 3, 20), (-4, -7, h + 5, w + 40),
             (1, 32, h - 1, 64), (0, 31, h, 33), (2, 0, 9, 32),
             (5, 10, 2, 30), (0, 0, h, w)]
    rois[:len(edges)] = edges[:b]
    return rois.astype(np.int32)


def _words(packed: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(packed.view(np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# plain packed versions vs the JAX references and Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lv,uv", RANGES)
@pytest.mark.parametrize("w", WIDTHS)
def test_cp_count_packed_matches_jax(w, lv, uv):
    masks = _binary((B, H, w), seed=w)
    packed = pack_masks(masks)
    rois = _edge_rois(B, H, w, seed=w + 1)
    got = ops.cp_count_packed(_words(packed), torch.from_numpy(rois), lv, uv)
    assert got.dtype == torch.int32 and got.shape == (B,)
    _eq(got, jpk.cp_count_packed_ref(jnp.asarray(packed), jnp.asarray(rois),
                                     lv, uv))
    # on ROIs clipped to the mask, the float kernel on the unpacked masks
    # agrees (an unclipped ROI counts the zero tail bits past W as pixels)
    clipped = torch.from_numpy(np.clip(rois, 0, [H, w, H, w]))
    _eq(ops.cp_count_packed(_words(packed), clipped, lv, uv),
        ops.cp_count(torch.from_numpy(masks), clipped, lv, uv))


@pytest.mark.parametrize("w", WIDTHS)
def test_cp_count_multi_packed_matches_jax(w):
    packed = pack_masks(_binary((B, H, w), seed=3 * w))
    rois = np.stack([_edge_rois(B, H, w, seed=20 + i)[::1 - 2 * (i % 2)]
                     for i in range(len(RANGES))])
    lvs = np.asarray([r[0] for r in RANGES], np.float32)
    uvs = np.asarray([r[1] for r in RANGES], np.float32)
    got = ops.cp_count_multi_packed(_words(packed), torch.from_numpy(rois),
                                    lvs, uvs)
    assert got.shape == (len(RANGES), B)
    _eq(got, jpk.cp_count_multi_packed_ref(jnp.asarray(packed),
                                           jnp.asarray(rois), lvs, uvs))
    empty = ops.cp_count_multi_packed(_words(packed), np.zeros((0, B, 4)),
                                      np.zeros(0), np.zeros(0))
    assert empty.shape == (0, B)


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_mask_agg_counts_packed_matches_jax(w, thresh):
    n, s = B // 3, 3
    packed = pack_masks(_binary((n, s, H, w), seed=7 * w))
    rois = _edge_rois(n, H, w, seed=w + 5)
    gi, gu = ops.mask_agg_counts_packed(_words(packed), rois, thresh)
    wi, wu = jpk.mask_agg_counts_packed_ref(jnp.asarray(packed),
                                            jnp.asarray(rois), thresh)
    _eq(gi, wi)
    _eq(gu, wu)


@pytest.mark.parametrize("pattern", ["random", "all", "none"])
@pytest.mark.parametrize("w", WIDTHS)
def test_fused_bounds_verify_matches_jax(w, pattern):
    q = 3
    packed = pack_masks(_binary((B, H, w), seed=11 * w))
    rois = np.stack([_edge_rois(B, H, w, seed=40 + i) for i in range(q)])
    lvs = np.asarray([0.5, -0.5, 0.0], np.float32)
    uvs = np.asarray([1.5, 0.5, 1.0], np.float32)
    rng = np.random.default_rng(w)
    decided = {"random": rng.random((q, B)) < 0.5,
               "all": np.ones((q, B), bool),
               "none": np.zeros((q, B), bool)}[pattern].astype(np.int32)
    lb = rng.integers(0, 1000, (q, B)).astype(np.int32)   # sentinels
    got = ops.fused_bounds_verify(_words(packed), rois, lvs, uvs, decided, lb)
    _eq(got, jpk.fused_verify_packed_ref(jnp.asarray(packed),
                                         jnp.asarray(rois), lvs, uvs,
                                         jnp.asarray(decided),
                                         jnp.asarray(lb)))


# positions into the resident words: repeated (an unclipped ROI's row 2
# among them), out of order, none
POSITIONS = {"repeat": [5, 0, 5, 2, 23, 23, 2],
             "unsorted": [23, 7, 1, 16, 2, 9, 0],
             "empty": []}


@pytest.mark.parametrize("pattern", ["random", "all", "none"])
@pytest.mark.parametrize("pos", list(POSITIONS))
@pytest.mark.parametrize("w", (33, 40))
def test_fused_bounds_verify_positions_match_jax(w, pos, pattern):
    """The megakernel's plain version reading ``packed[positions]`` equals
    the JAX reference on the gathered rows (unclipped ROIs included) and,
    for W = 40, the Pallas kernel in interpret mode on clipped ROIs."""
    q = 3
    packed = pack_masks(_binary((B, H, w), seed=13 * w))
    positions = np.asarray(POSITIONS[pos], np.int64)
    b = len(positions)
    rois = np.stack([_edge_rois(B, H, w, seed=60 + i)[positions]
                     for i in range(q)])
    lvs = np.asarray([0.5, -0.5, 0.0], np.float32)
    uvs = np.asarray([1.5, 0.5, 1.0], np.float32)
    rng = np.random.default_rng(w + b)
    decided = {"random": rng.random((q, b)) < 0.5,
               "all": np.ones((q, b), bool),
               "none": np.zeros((q, b), bool)}[pattern].astype(np.int32)
    lb = rng.integers(0, 1000, (q, b)).astype(np.int32)
    got = ops.fused_bounds_verify(_words(packed), rois, lvs, uvs, decided, lb,
                                  positions)
    assert got.dtype == torch.int32 and got.shape == (q, b)
    if not b:
        return
    gathered = jnp.asarray(packed[positions])
    _eq(got, jpk.fused_verify_packed_ref(gathered, jnp.asarray(rois), lvs,
                                         uvs, jnp.asarray(decided),
                                         jnp.asarray(lb)))
    if w == 40:     # the Pallas tiling needs H to divide into row tiles
        clipped = np.clip(rois, 0, [H, w, H, w])
        _eq(ops.fused_bounds_verify(_words(packed), clipped, lvs, uvs,
                                    decided, lb, positions),
            jpk.fused_verify_packed_pallas(
                gathered, jnp.asarray(clipped), jnp.asarray(lvs),
                jnp.asarray(uvs), jnp.asarray(decided), jnp.asarray(lb),
                interpret=True))


@pytest.mark.parametrize("pos", list(POSITIONS))
@pytest.mark.parametrize("w", (33, 40))
def test_cp_count_multi_packed_positions_match_jax(w, pos):
    """The Q-descriptor plain version reading ``packed[positions]``
    (repeated, out of order, none) equals the JAX reference on the
    gathered rows (unclipped and empty ROIs and lv == uv among the
    descriptors), takes the positions as a tensor alike, and, for W = 40,
    equals the Pallas kernel in interpret mode on clipped ROIs."""
    packed = pack_masks(_binary((B, H, w), seed=17 * w))
    positions = np.asarray(POSITIONS[pos], np.int64)
    b = len(positions)
    rois = np.stack([_edge_rois(B, H, w, seed=80 + i)[positions]
                     for i in range(len(RANGES))])
    lvs = np.asarray([r[0] for r in RANGES], np.float32)
    uvs = np.asarray([r[1] for r in RANGES], np.float32)
    got = ops.cp_count_multi_packed(_words(packed), rois, lvs, uvs,
                                    positions)
    assert got.dtype == torch.int32 and got.shape == (len(RANGES), b)
    _eq(ops.cp_count_multi_packed(_words(packed), torch.from_numpy(rois),
                                  lvs, uvs, torch.from_numpy(positions)), got)
    if not b:
        return
    gathered = jnp.asarray(packed[positions])
    _eq(got, jpk.cp_count_multi_packed_ref(gathered, jnp.asarray(rois), lvs,
                                           uvs))
    if w == 40:     # the Pallas tiling needs H to divide into row tiles
        clipped = np.clip(rois, 0, [H, w, H, w])
        _eq(ops.cp_count_multi_packed(_words(packed), clipped, lvs, uvs,
                                      positions),
            jpk.cp_count_multi_packed_pallas(
                gathered, jnp.asarray(clipped), jnp.asarray(lvs),
                jnp.asarray(uvs), interpret=True))


def test_plain_versions_match_pallas_interpret():
    """One case per kernel against the Pallas body in interpret mode (the
    Pallas tiling needs H to divide into row tiles, so W = 40, H = 32)."""
    w = 40
    masks = _binary((6, H, w), seed=2)
    packed = pack_masks(masks)
    jp = jnp.asarray(packed)
    rois = np.clip(_edge_rois(6, H, w, seed=3), 0, [H, w, H, w])
    _eq(ops.cp_count_packed(_words(packed), rois, 0.5, 1.5),
        jpk.cp_count_packed_pallas(jp, jnp.asarray(rois), 0.5, 1.5,
                                   interpret=True))
    rois_q = np.stack([rois, rois[::-1]])
    lvs = np.asarray([0.5, -0.5], np.float32)
    uvs = np.asarray([1.5, 0.5], np.float32)
    _eq(ops.cp_count_multi_packed(_words(packed), rois_q, lvs, uvs),
        jpk.cp_count_multi_packed_pallas(jp, jnp.asarray(rois_q),
                                         jnp.asarray(lvs), jnp.asarray(uvs),
                                         interpret=True))
    decided = np.asarray([[1, 0, 1, 0, 0, 1], [0, 0, 1, 1, 0, 0]], np.int32)
    lb = np.arange(12, dtype=np.int32).reshape(2, 6) * 7
    _eq(ops.fused_bounds_verify(_words(packed), rois_q, lvs, uvs, decided,
                                lb),
        jpk.fused_verify_packed_pallas(jp, jnp.asarray(rois_q),
                                       jnp.asarray(lvs), jnp.asarray(uvs),
                                       jnp.asarray(decided), jnp.asarray(lb),
                                       interpret=True))
    grp = packed.reshape(3, 2, H, -1)
    for got, want in zip(
            ops.mask_agg_counts_packed(_words(grp), rois[:3], 0.5),
            jpk.mask_agg_counts_packed_pallas(jnp.asarray(grp),
                                              jnp.asarray(rois[:3]), 0.5,
                                              interpret=True)):
        _eq(got, want)


def test_plain_versions_take_only_int32_words():
    packed = pack_masks(_binary((2, 4, 40), seed=1))
    rois = np.tile([0, 0, 4, 40], (2, 1))
    for bad in (torch.from_numpy(packed), torch.from_numpy(
            packed.astype(np.float32))):
        with pytest.raises(TypeError):
            ops.cp_count_packed(bad, rois, 0.5, 1.5)


# ---------------------------------------------------------------------------
# lv / uv / t rounded to float32 before the flags, as in the JAX wrappers
# ---------------------------------------------------------------------------

ROUNDING = (-0.5, 0.0, 0.5, 1.0, 1.5, 1e-46, -1e-46, 0.99999999,
            1.00000001, 3.4e38, float("inf"))


@pytest.mark.parametrize("lv", ROUNDING)
def test_range_flags_round_like_jax(lv):
    for uv in ROUNDING:
        jf1, jf0 = jpk._range_flags(lv, uv)
        assert tuple(ref._range_flags(lv, uv)) == (int(jf1), int(jf0)), uv
    # end to end: a value that rounds across 0 or 1 changes the count
    packed = pack_masks(_binary((4, 8, 40), seed=9))
    rois = np.tile([0, 0, 8, 40], (4, 1))
    for uv in ROUNDING:
        _eq(ops.cp_count_packed(_words(packed), rois, lv, uv),
            jpk.cp_count_packed_ref(jnp.asarray(packed), jnp.asarray(rois),
                                    lv, uv))


def test_thresh_flags_round_like_jax():
    for t in ROUNDING + (-1.00000001, -0.99999999):
        jf1, jf0 = jpk._thresh_flags(t)
        assert ref._thresh_flags(t) == (int(jf1), int(jf0)), t
    # 0.99999999 is 1.0 in float32: no pixel is above it
    assert ref._thresh_flags(0.99999999) == (0, 0)
    assert ref._thresh_flags(np.float64(1e-46)) == (1, 0)


# ---------------------------------------------------------------------------
# the packed store
# ---------------------------------------------------------------------------


def _data(n, seed, id_base=0, w=W):
    boxes = object_boxes(n, H, w, seed=seed + 1)
    m, _ = saliency_masks(n, H, w, seed=seed, attacked_fraction=0.25,
                          boxes=boxes)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = id_base + np.arange(n)
    meta["image_id"] = (id_base + np.arange(n)) // 2
    meta["mask_type"] = np.arange(n) % 3 + 1
    return (m > 0.5).astype(np.float32), meta, boxes


def _assert_same_packed_store(j, t):
    assert t.packed and j.packed and t.epoch == j.epoch
    np.testing.assert_array_equal(t.meta, j.meta)
    np.testing.assert_array_equal(t.chi_host(), j.chi_host())
    np.testing.assert_array_equal(t.chi_table.numpy(), j.chi_host())
    res = t.resident_masks()
    assert res.dtype == np.uint32
    np.testing.assert_array_equal(res, j.resident_masks())
    dev = t.device_masks()
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy().view(np.uint32),
                                  j.resident_masks())
    assert t.load(np.arange(len(t))).dtype == np.uint32
    for g in t.cfg.tier_grids:
        np.testing.assert_array_equal(t.chi_tier_table(g).numpy(),
                                      j.chi_tier_host(g))


@pytest.mark.parametrize("w", WIDTHS)
def test_packed_mutation_sequence_with_resident_words_matches_jax(w):
    """append / update / delete on a packed store whose device words (and
    CHI caches) were materialized first — the in-place ``index_copy_`` of
    the words, which torch refuses on uint32."""
    cfg = dict(grid=4, num_bins=8, height=H, width=w)
    masks, meta, _ = _data(B, seed=1, w=w)
    j = JStore.create_memory(masks, meta, JCfg(**cfg), packed=True)
    t = TStore.create_memory(masks, meta, TCfg(**cfg), packed=True,
                             device="cpu")
    _assert_same_packed_store(j, t)
    add, add_meta, _ = _data(4, seed=5, id_base=1000, w=w)
    upd = _binary((3, H, w), seed=6)
    steps = [lambda s: s.append(add, add_meta),
             lambda s: s.update([2, 5, 1001], upd),
             lambda s: s.delete([0, 7, 1003]),
             lambda s: s.update([1], np.ones((1, H, w), np.float32))]
    for step in steps:
        assert step(t) == step(j)
        _assert_same_packed_store(j, t)
        sql = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
               "CP(mask, full_img, (0.5, 1.5)) DESC LIMIT 5;")
        for be in ("host", "device"):
            got, _ = tq.run(sql, t, backend=be)
            want, _ = jq.run(sql, j, backend=be)
            _eq(got[0], want[0])
            _eq(got[1], want[1])


def test_packed_store_rejects_nonbinary_ingest():
    cfg = TCfg(grid=4, num_bins=8, height=H, width=W)
    gray, meta, _ = _data(4, seed=2)
    gray = gray * 0.5 + 0.25
    with pytest.raises(ValueError, match="binary"):
        TStore.create_memory(gray, meta, cfg, packed=True, device="cpu")
    masks, meta, _ = _data(4, seed=3)
    store = TStore.create_memory(masks, meta, cfg, packed=True, device="cpu")
    store.device_masks()
    with pytest.raises(ValueError, match="binary"):
        store.update([0], np.full((1, H, W), 0.5, np.float32))
    more = meta.copy()
    more["mask_id"] += 100
    with pytest.raises(ValueError, match="binary"):
        store.append(gray, more)
    assert store.epoch == 0 and len(store) == 4


def test_from_reference_state_reproduces_a_packed_jax_store():
    masks, meta, _ = _data(B, seed=4, w=40)
    cfg = dict(grid=4, num_bins=8, height=H, width=40)
    j = JStore.create_memory(masks[:16], meta[:16], JCfg(**cfg), packed=True)
    j.append(masks[16:], meta[16:])
    state = dict(masks=j.resident_masks(), meta=j.meta, chi=j.chi_host(),
                 chunk_lens=[len(c) for c in j.chi_chunks], epoch=j.epoch,
                 cfg=dataclasses.asdict(j.cfg), packed=j.packed)
    t = TStore.from_reference_state(state, device="cpu")
    _assert_same_packed_store(j, t)
    assert [len(c) for c in t.chi_chunks] == [16, B - 16]
    assert t.row_nbytes == j.row_nbytes == H * 2 * 4


# ---------------------------------------------------------------------------
# packed queries: host ≡ device(cpu) ≡ JAX host ≡ the float store
# ---------------------------------------------------------------------------

SMOKE_SQL = {
    "packed_filter": "SELECT mask_id FROM MasksDatabaseView WHERE "
                     "CP(mask, roi, (0.5, 1.5)) / AREA(roi) < 0.5;",
    "packed_topk": "SELECT mask_id FROM MasksDatabaseView ORDER BY "
                   "CP(mask, (3, 5, 29, 31), (0.5, 1.5)) DESC LIMIT 8;",
    "packed_refine": "SELECT mask_id FROM MasksDatabaseView WHERE "
                     "CP(mask, roi, (0.5, 1.5)) > 20 AND NOT "
                     "CP(mask, full_img, (0.5, 1.5)) < 60 ORDER BY "
                     "CP(mask, (3, 5, 29, 31), (0.5, 1.5)) DESC LIMIT 8;",
    "scenario3_iou": jq.SCENARIO3_IOU,
}
PLANS = [
    LogicalPlan(predicate=Cmp(CP((4, 4, 28, 28), 0.5, 1.5), ">", 40.0),
                order_by=BinOp("/", CP("provided", 0.5, 1.5),
                               RoiArea("provided")), k=4),
    LogicalPlan(predicate=Cmp(CP(None, -0.5, 0.5), "<", 700.0)),
    LogicalPlan(agg="SUM", agg_expr=CP(None, 0.5, 1.5)),
    LogicalPlan(agg="MAX", agg_expr=CP("provided", 0.5, 1.5)),
    LogicalPlan(order_by=CP((3, 5, 29, 31), 0.0, 1.0), k=6, desc=False),
    LogicalPlan(select="image_id", order_by=AggCP("intersect", 0.5, None),
                k=6),
    LogicalPlan(select="image_id",
                order_by=BinOp("/", AggCP("intersect", 0.5, None),
                               AggCP("union", 0.5, None)),
                k=6, desc=False),
]


@pytest.fixture(scope="module")
def packed_db():
    masks, meta, rois = _data(B, seed=4)
    cfg = dict(grid=4, num_bins=8, height=H, width=W)
    # create on two thirds, append the rest: packed ingest as the smoke
    # drives it
    j = JStore.create_memory(masks[:16], meta[:16], JCfg(**cfg), packed=True)
    j.append(masks[16:], meta[16:])
    t = TStore.create_memory(masks[:16], meta[:16], TCfg(**cfg), packed=True,
                             device="cpu")
    t.append(masks[16:], meta[16:])
    f = TStore.create_memory(masks, meta, TCfg(**cfg), device="cpu")
    return j, t, f, rois


def _same(got, want, label, stats=True):
    (gres, gst), (wres, wst) = got, want
    if isinstance(wres, tuple):
        _eq(gres[0], wres[0])
        _eq(gres[1], wres[1])
    elif isinstance(wres, float):
        assert gres == wres or (np.isnan(gres) and np.isnan(wres)), label
    else:
        _eq(gres, wres)
    if stats:
        for f in STATS:
            assert getattr(gst, f) == getattr(wst, f), (label, f)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("name", list(SMOKE_SQL))
def test_packed_queries_match_jax_and_float(packed_db, name, backend):
    j, t, f, rois = packed_db
    sql = SMOKE_SQL[name]
    got = tq.run(sql, t, provided_rois=rois, backend=backend, verify_batch=5)
    _same(got, jq.run(sql, j, provided_rois=rois, backend=backend,
                      verify_batch=5), f"{name}/{backend}")
    # host ≡ device on the port (the device backend loads no bytes), and
    # ids/scores equal the float store and the naive scan (the
    # cp_count_packed path)
    host = tq.run(sql, t, provided_rois=rois, backend="host", verify_batch=5)
    _same(got, host, f"{name}/host", stats=False)
    for fld in ("n_candidates", "n_decided_by_bounds", "n_verified",
                "n_rounds"):
        assert getattr(got[1], fld) == getattr(host[1], fld), fld
    _same(got, tq.run(sql, f, provided_rois=rois, backend=backend,
                      verify_batch=5), f"{name}/float", stats=False)
    _same(got, tq.run(sql, t, provided_rois=rois, use_index=False),
          f"{name}/scan", stats=False)
    if name != "scenario3_iou":       # S3's groups are all decided here
        assert got[1].n_verified > 0


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_packed_plans_equivalent_across_backends_and_to_float(packed_db, i):
    from repro.core import plan as jplan
    j, t, f, rois = packed_db
    plan = PLANS[i]
    jplan_obj = _to_jax_plan(plan, jplan)
    want = jplan.run_plan(j, jplan_obj, provided_rois=rois, verify_batch=5)
    for be in ("host", "device"):
        got = run_plan(t, plan, provided_rois=rois, verify_batch=5,
                       backend=be)
        _same(got, jplan.run_plan(j, jplan_obj, provided_rois=rois,
                                  verify_batch=5, backend=be), f"{i}/{be}")
        _same(got, want, f"{i}/{be} vs jax host", stats=False)
        _same(got, run_plan(f, plan, provided_rois=rois, verify_batch=5,
                            backend=be), f"{i}/{be} vs float", stats=False)


def _to_jax_plan(plan, jplan):
    """The same LogicalPlan built from the JAX package's IR classes."""
    from repro.core import exprs as jx
    from repro_torch.core import exprs as tx

    def conv(node):
        if node is None:
            return None
        cls = getattr(jx, type(node).__name__)
        if dataclasses.is_dataclass(node):
            return cls(**{fld.name: conv(getattr(node, fld.name))
                          if isinstance(getattr(node, fld.name),
                                        (tx.Node, tx.Pred))
                          else getattr(node, fld.name)
                          for fld in dataclasses.fields(node)})
        raise TypeError(node)

    kw = {fld.name: conv(getattr(plan, fld.name))
          if isinstance(getattr(plan, fld.name), (tx.Node, tx.Pred))
          else getattr(plan, fld.name)
          for fld in dataclasses.fields(plan)}
    return jplan.LogicalPlan(**kw)


def test_fused_counts_identical_across_backends_and_jax(packed_db):
    j, t, _, rois = packed_db
    pos = np.array([0, 3, 7, 8, 15, 16, 23])
    specs = [(rois[pos], 0.5, 1.5), (np.tile([0, 0, H, W], (7, 1)), 0.0, 1.0),
             (np.tile([3, 5, 29, 31], (7, 1)), -0.5, 0.5),
             (np.tile([0, 30, H, 64], (7, 1)), 0.5, float("inf"))]
    want = jget_backend(j, "host").fused_counts(j, pos, specs)
    for name in ("host", "device"):
        _eq(get_backend(t, name).fused_counts(t, pos, specs), want)


def test_fused_verify_counts_pass_decided_bounds_through(packed_db):
    """The driver assembles CHI verdicts from memoized bounds; decided
    entries come back as their (here deliberately wrong) bound on both
    backends, undecided ones as exact counts."""
    _, t, _, rois = packed_db
    terms = [CP("provided", 0.5, 1.5), CP(None, -0.5, 0.5),
             CP((3, 5, 29, 31), 0.5, 1.5)]
    batch = np.array([1, 4, 9, 17, 22])
    exact = get_backend(t, "host").verify_counts(
        MaskEvalContext(t, np.arange(B), rois), batch, terms)
    memo = {terms[0]: (np.full(B, 7.0), np.full(B, 7.0)),
            terms[1]: (np.zeros(B), np.full(B, 1e9))}
    decided, lb = chi_verdicts(terms, batch, memo.get)
    assert decided[0].all() and not decided[1:].any()
    for name in ("host", "device"):
        got = get_backend(t, name).fused_verify_counts(
            MaskEvalContext(t, np.arange(B), rois), batch, terms, memo.get)
        _eq(got[terms[0]], np.full(len(batch), 7.0))
        _eq(got[terms[1]], exact[terms[1]])
        _eq(got[terms[2]], exact[terms[2]])


def test_device_verification_reads_resident_words_in_place(packed_db,
                                                           monkeypatch):
    """The device backend's packed verification step hands the megakernel
    the resident words with the batch's positions and gathers nothing; the
    answers stay those of the host backend."""
    _, t, _, rois = packed_db
    resident = get_backend(t, "device")._masks
    seen = []
    plain = ops.fused_bounds_verify.plain

    def spy(packed, *args):
        seen.append((packed, args[5] if len(args) > 5 else None))
        return plain(packed, *args)

    def no_gather(*args, **kwargs):
        raise AssertionError("the verification step gathered rows")
    want = {name: tq.run(SMOKE_SQL[name], t, provided_rois=rois,
                         backend="host", verify_batch=5)
            for name in ("packed_filter", "packed_refine")}
    monkeypatch.setattr(ops.fused_bounds_verify, "plain", spy)
    monkeypatch.setattr(torch.Tensor, "index_select", no_gather)
    for name, (wres, _) in want.items():
        got, stats = tq.run(SMOKE_SQL[name], t, provided_rois=rois,
                            backend="device", verify_batch=5)
        _eq(got if not isinstance(got, tuple) else got[0],
            wres if not isinstance(wres, tuple) else wres[0])
        assert stats.n_verified > 0
    monkeypatch.undo()
    assert seen
    for packed, pos in seen:
        assert packed is resident and pos is not None
        assert pos.dtype == np.int64 and len(pos) > 0


# the scheduler's fused-pass descriptors over ``_MULTI_POS`` (repeated and
# out of order): per-mask boxes, the full image, an off-grid box with
# lv == uv, columns past W, an empty ROI
_MULTI_POS = np.array([23, 7, 7, 0, 16, 2, 9, 2])
_MULTI_TERMS = [CP("provided", 0.5, 1.5), CP(None, -0.5, 0.5),
                CP((3, 5, 29, 31), 0.5, 0.5), CP((0, 30, H, 64), 0.0, 1.0),
                CP((4, 4, 4, 20), 0.5, 1.5)]


def _multi_specs(rois):
    n = len(_MULTI_POS)
    return [(rois[_MULTI_POS], 0.5, 1.5), (np.tile([0, 0, H, W], (n, 1)),
                                           -0.5, 0.5),
            (np.tile([3, 5, 29, 31], (n, 1)), 0.5, 0.5),
            (np.tile([0, 30, H, 64], (n, 1)), 0.0, 1.0),
            (np.tile([4, 4, 4, 20], (n, 1)), 0.5, 1.5)]


def _multi_step(step, backend, t, rois):
    """The backend's packed Q-descriptor step over ``_MULTI_POS`` →
    (Q, B) counts."""
    if step == "fused_counts":
        return np.asarray(backend.fused_counts(t, _MULTI_POS,
                                               _multi_specs(rois)))
    got = backend.verify_counts(MaskEvalContext(t, np.arange(B), rois),
                                _MULTI_POS, _MULTI_TERMS)
    return np.stack([got[term] for term in _MULTI_TERMS])


@pytest.mark.parametrize("step", ["fused_counts", "verify_counts"])
def test_device_multi_count_steps_read_resident_words_in_place(
        packed_db, monkeypatch, step):
    """The device backend's packed Q-descriptor steps (the scheduler's
    fused pass and ``verify_counts``) hand the kernel the resident words
    with the batch's host int64 positions, repeated and out of order, and
    gather nothing; the counts equal the host backend's and, for the
    fused pass, the JAX package's."""
    j, t, _, rois = packed_db
    resident = get_backend(t, "device")._masks
    want = _multi_step(step, get_backend(t, "host"), t, rois)
    if step == "fused_counts":
        _eq(want, jget_backend(j, "host").fused_counts(j, _MULTI_POS,
                                                       _multi_specs(rois)))
    seen = []
    plain = ops.cp_count_multi_packed.plain

    def spy(packed, *args):
        seen.append((packed, args[3] if len(args) > 3 else None))
        return plain(packed, *args)

    def no_gather(*args, **kwargs):
        raise AssertionError("the multi-count step gathered rows")
    monkeypatch.setattr(ops.cp_count_multi_packed, "plain", spy)
    monkeypatch.setattr(torch.Tensor, "index_select", no_gather)
    got = _multi_step(step, get_backend(t, "device"), t, rois)
    monkeypatch.undo()
    _eq(got, want)
    assert len(seen) == 1
    packed, pos = seen[0]
    assert packed is resident
    assert isinstance(pos, np.ndarray) and pos.dtype == np.int64
    _eq(pos, _MULTI_POS)


def test_host_fused_counts_counts_the_rows_it_loaded(packed_db,
                                                     monkeypatch):
    """The host backend's fused pass calls the kernel on the rows it
    loaded, one per position, with no positions."""
    _, t, _, rois = packed_db
    seen = []
    plain = ops.cp_count_multi_packed.plain

    def spy(packed, *args):
        seen.append((packed, args[3] if len(args) > 3 else None))
        return plain(packed, *args)
    monkeypatch.setattr(ops.cp_count_multi_packed, "plain", spy)
    _multi_step("fused_counts", get_backend(t, "host"), t, rois)
    monkeypatch.undo()
    assert len(seen) == 1
    packed, pos = seen[0]
    assert pos is None
    assert packed is not get_backend(t, "device")._masks
    assert tuple(packed.shape) == (len(_MULTI_POS),) + tuple(
        t.device_masks().shape[1:])


def _dispatches(kernel):
    snap = REGISTRY.snapshot().get("masksearch_kernel_launches_total", {})
    return snap.get(f"kernel={kernel}", 0.0)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_megakernel_one_dispatch_per_verify_batch(packed_db, backend):
    _, t, _, _ = packed_db
    run = TopKRun(t, CP((3, 5, 29, 31), 0.5, 1.5), verify_batch=4,
                  backend=backend)
    run.target(8)
    before = _dispatches("fused_bounds_verify")
    n_batches = 0
    while not run.finished():
        batch = run.take_batch()
        if not len(batch):
            break
        run.self_verify(batch)
        n_batches += 1
    assert n_batches >= 2
    assert _dispatches("fused_bounds_verify") - before == n_batches
