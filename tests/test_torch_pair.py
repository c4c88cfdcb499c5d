"""PyTorch port: the dual-mask pair operator vs the JAX package.

The same inputs, made from fixed numpy seeds, go through both packages:
the plain pair-count versions against the JAX references and Pallas
kernels (interpret mode), the device-side pair cell bounds against
``cell_counts_jnp`` / ``pair_cell_bounds_jnp`` and the host numpy path,
and pair plans and SQL on float and packed stores of per-image
(saliency, attention) pairs, on the host and device backends
(``device="cpu"`` here, so each kernel wrapper runs its plain version)
and as naive scans.  Every output is an int32 count or a float64 built
from one, so equality is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CHIConfig as JCfg
from repro.core import MaskStore as JStore
from repro.core import exprs as jx
from repro.core import plan as jplan
from repro.core import queries as jq
from repro.core.packing import pack_masks
from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from repro.kernels import pair_count as jpair
from repro.kernels import popcount as jpk
from repro.kernels import ref as jref
from repro_torch.core import CHIConfig as TCfg
from repro_torch.core import MaskStore as TStore
from repro_torch.core import exprs as tx
from repro_torch.core import queries as tq
from repro_torch.core.backend import get_backend
from repro_torch.core.engine import PairFilterRun, PairTopKRun, TopKRun
from repro_torch.core.plan import LogicalPlan, run_plan
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY

# test_pair_properties.py's store: 30 images of 32x32, grid 4, 8 bins
N_IMG, H, W = 30, 32, 32
WIDTHS = (32, 33, 40)
THRESHOLDS = (-0.5, 0.0, 0.5, 1.0, 1.5)
STATS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds",
         "n_dropped_masks", "bytes_loaded", "bytes_saved", "chi_bytes")


def _edge_rois(b, h, w, seed):
    """Random ROIs plus the edge cases of ``test_torch_packed.py``:
    unclipped (c1 past W and past the last word), empty, negative starts
    and columns on word edges."""
    rng = np.random.default_rng(seed)
    r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
    c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
    rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
    edges = [(0, 0, h, 64), (3, 5, 3, 20), (-4, -7, h + 5, w + 40),
             (1, 32, h - 1, 64), (0, 31, h, 33), (2, 0, 9, 32),
             (5, 10, 2, 30), (0, 0, h, w)]
    rois[:len(edges)] = edges[:b]
    return rois.astype(np.int32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _eq3(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


# ---------------------------------------------------------------------------
# plain pair-count versions vs the JAX references and Pallas kernels
# ---------------------------------------------------------------------------


def _float_pair(b, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((b, H, w), dtype=np.float32)
    m = rng.random((b, H, w), dtype=np.float32)
    # pixels exactly on the thresholds below, and the bf16 case:
    # bf16(0.80078125) is not above bf16(0.8), though f32 0.80078125 > 0.8
    a[:, ::3, :] = np.float32(0.80078125)
    m[:, :, ::4] = np.float32(0.5)
    return a, m


@pytest.mark.parametrize("ta,tb", [(0.8, 0.5), (0.5, 0.8), (0.3, 0.3),
                                   (-1.0, 2.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", WIDTHS)
def test_pair_counts_plain_matches_jax(w, dtype, ta, tb):
    b = 12
    a, m = _float_pair(b, w, seed=w)
    rois = np.clip(_edge_rois(b, H, w, seed=w + 1), -8, None)
    ta_, tb_ = torch.from_numpy(a), torch.from_numpy(m)
    ja, jm = jnp.asarray(a), jnp.asarray(m)
    if dtype == "bfloat16":
        ta_, tb_ = ta_.to(torch.bfloat16), tb_.to(torch.bfloat16)
        ja, jm = ja.astype(jnp.bfloat16), jm.astype(jnp.bfloat16)
    got = ops.pair_counts(ta_, tb_, torch.from_numpy(rois), ta, tb)
    _eq3(got, jref.pair_counts_ref(ja, jm, jnp.asarray(rois), ta, tb))
    # the Pallas kernel (interpret mode) on the same inputs
    _eq3(got, jpair.pair_counts_pallas(ja, jm, jnp.asarray(rois), ta, tb,
                                       interpret=True))


def test_pair_counts_bf16_threshold_rounds_to_the_mask_dtype():
    """A bf16 pixel of 0.80078125 is not above ta = 0.8: in bf16 the
    threshold is 0.80078125 too.  A float32 compare would count it."""
    a = torch.full((1, 2, 2), 0.80078125).to(torch.bfloat16)
    m = torch.zeros((1, 2, 2), dtype=torch.bfloat16)
    rois = torch.tensor([[0, 0, 2, 2]], dtype=torch.int32)
    inter, union, diff = ops.pair_counts(a, m, rois, 0.8, 0.5)
    assert (int(inter), int(union), int(diff)) == (0, 0, 0)
    inter, union, diff = ops.pair_counts(a.float(), m.float(), rois, 0.8, 0.5)
    assert (int(inter), int(union), int(diff)) == (0, 4, 4)


def _unpack(packed, w):
    """LSB-first uint32 words (B, H, nw) → (B, H, w) float32 0/1."""
    bits = np.unpackbits(packed.view(np.uint8), axis=-1, bitorder="little")
    return torch.from_numpy(bits[..., :w].astype(np.float32))


@pytest.mark.parametrize("ta", THRESHOLDS)
@pytest.mark.parametrize("w", WIDTHS)
def test_pair_counts_packed_plain_matches_jax(w, ta):
    b = 12
    rng = np.random.default_rng(3 * w)
    pa = pack_masks(rng.random((b, H, w)) < 0.4)
    pb = pack_masks(rng.random((b, H, w)) < 0.5)
    rois = _edge_rois(b, H, w, seed=w + 7)
    ja, jb, jr = jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(rois)
    for tb in THRESHOLDS:
        got = ops.pair_counts_packed(torch.from_numpy(pa.view(np.int32)),
                                     torch.from_numpy(pb.view(np.int32)),
                                     torch.from_numpy(rois), ta, tb)
        _eq3(got, jpk.pair_counts_packed_ref(ja, jb, jr, ta, tb))
        if w == 40:     # the Pallas tiling needs H to divide into row tiles
            _eq3(got, jpk.pair_counts_packed_pallas(ja, jb, jr, ta, tb,
                                                    interpret=True))
        # on ROIs clipped to the mask, the float kernel on the unpacked
        # binary masks agrees (an unclipped ROI counts tail bits past W)
        clipped = torch.from_numpy(np.clip(rois, 0, [H, w, H, w]))
        _eq3(ops.pair_counts_packed(torch.from_numpy(pa.view(np.int32)),
                                    torch.from_numpy(pb.view(np.int32)),
                                    clipped, ta, tb),
             ops.pair_counts(_unpack(pa, w), _unpack(pb, w), clipped, ta, tb))


# (pos_a, pos_b) into the resident words: repeated, out of order, none
PAIR_POSITIONS = {"repeat": ([3, 0, 3, 2, 11, 11], [0, 0, 7, 7, 2, 2]),
                  "unsorted": ([11, 4, 2, 9, 0, 1, 6], [6, 2, 10, 4, 5, 3, 0]),
                  "empty": ([], [])}


@pytest.mark.parametrize("pos", list(PAIR_POSITIONS))
@pytest.mark.parametrize("w", (33, 40))
def test_pair_counts_packed_positions_match_jax(w, pos):
    """The packed pair counts' plain version reading each role in place
    through its positions equals the JAX reference on the gathered rows,
    called once per descriptor as a verification pass calls it (unclipped
    ROIs included), and for W = 40 the Pallas kernel in interpret mode."""
    n = 12
    rng = np.random.default_rng(5 * w)
    pa = pack_masks(rng.random((n, H, w)) < 0.4)
    pb = pack_masks(rng.random((n, H, w)) < 0.5)
    pos_a, pos_b = (np.asarray(p, np.int64) for p in PAIR_POSITIONS[pos])
    b = len(pos_a)
    wa = torch.from_numpy(pa.view(np.int32))
    wb = torch.from_numpy(pb.view(np.int32))
    ja, jb = jnp.asarray(pa[pos_a]), jnp.asarray(pb[pos_b])
    specs = [(_edge_rois(n, H, w, seed=w + 9)[pos_a], 0.6, 0.6),
             (np.tile([0, 0, H, 64], (b, 1)), -0.5, 0.5),
             (_edge_rois(n, H, w, seed=w + 10)[pos_b], 1.0, 0.0)]
    for rois, ta, tb in specs:
        rois = rois.astype(np.int32)
        got = ops.pair_counts_packed(wa, wb, torch.from_numpy(rois), ta, tb,
                                     pos_a, pos_b)
        if not b:
            assert all(g.shape == (0,) for g in got)
            continue
        _eq3(got, jpk.pair_counts_packed_ref(ja, jb, jnp.asarray(rois), ta,
                                             tb))
        if w == 40:     # the Pallas tiling needs H to divide into row tiles
            _eq3(got, jpk.pair_counts_packed_pallas(
                ja, jb, jnp.asarray(rois), ta, tb, interpret=True))


def test_pair_plain_versions_take_only_int32_words():
    packed = torch.from_numpy(pack_masks(np.ones((2, 4, 40), bool)))
    rois = np.tile([0, 0, 4, 40], (2, 1))
    with pytest.raises(TypeError):
        ops.pair_counts_packed(packed, packed, rois, 0.5, 0.5)


# ---------------------------------------------------------------------------
# the per-image (saliency, attention) stores
# ---------------------------------------------------------------------------


def _pair_data(n_img=N_IMG, seed=8):
    """``test_pair_properties._db``'s recipe: per image a model-saliency
    mask (type 1) and a human-attention mask (type 2), 30% of the images
    with off-object attention."""
    rng = np.random.default_rng(seed)
    boxes = object_boxes(n_img, H, W, seed=4)
    model, _ = saliency_masks(n_img, H, W, seed=5, boxes=boxes,
                              in_box_fraction=1.0)
    off, _ = saliency_masks(n_img, H, W, seed=7, boxes=None)
    mis = rng.random(n_img) < 0.3
    human = np.where(mis[:, None, None], off,
                     np.clip(0.9 * model, 0.0, 1.0 - 1e-6))
    masks = np.stack([model, human], axis=1).reshape(-1, H, W)
    meta = np.zeros(len(masks), MASK_META_DTYPE)
    meta["mask_id"] = np.arange(len(masks))
    meta["image_id"] = np.arange(len(masks)) // 2
    meta["mask_type"] = np.arange(len(masks)) % 2 + 1
    return masks, meta, np.repeat(boxes, 2, axis=0)


def _stores(packed: bool):
    masks, meta, rois = _pair_data()
    if packed:      # bench_pair.py's binarisation
        masks = (masks > 0.5).astype(np.float32)
    cfg = dict(grid=4, num_bins=8, height=H, width=W)
    # create on the first 40 masks, append the rest: the ingest path
    j = JStore.create_memory(masks[:40], meta[:40], JCfg(**cfg),
                             packed=packed)
    j.append(masks[40:], meta[40:])
    t = TStore.create_memory(masks[:40], meta[:40], TCfg(**cfg),
                             packed=packed, device="cpu")
    t.append(masks[40:], meta[40:])
    return j, t, rois


@pytest.fixture(scope="module")
def float_db():
    return _stores(packed=False)


@pytest.fixture(scope="module")
def packed_db():
    return _stores(packed=True)


@pytest.fixture(params=["float", "packed"])
def db(request, float_db, packed_db):
    return float_db if request.param == "float" else packed_db


# ---------------------------------------------------------------------------
# pair cell bounds on the device path vs JAX and the host numpy path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stat", ["inter", "union", "diff"])
def test_pair_cell_bounds_torch_match_jax_and_host(float_db, stat):
    j, t, rois = float_db
    cfg = t.cfg
    rng = np.random.default_rng(11)
    pos_a = rng.integers(0, len(t), 40)
    pos_b = rng.integers(0, len(t), 40)
    tables = t.chi_host()
    pair_rois = np.concatenate([_edge_rois(8, H, W, seed=1),
                                rois[pos_a[8:]]]).astype(np.int32)
    rb = np.asarray(cfg.row_bounds, np.int32)
    cb = np.asarray(cfg.col_bounds, np.int32)
    tt = torch.from_numpy(tables)
    for ta, tb in ((0.5, 0.5), (0.25, 0.8125), (0.6, 0.3), (1.0, -0.5)):
        ka = tx._threshold_ks(cfg, ta)
        kb = tx._threshold_ks(cfg, tb)
        cells = {}
        for name, pos, ks in (("a", pos_a, ka), ("b", pos_b, kb)):
            for which, k in zip(("lo", "hi"), ks):
                got = tx.cell_counts_torch(tt[torch.from_numpy(pos)], k)
                assert got.dtype == torch.int32
                _eq(got, jx.cell_counts_jnp(jnp.asarray(tables[pos]), k))
                _eq(got, tx._cell_counts(tables[pos], k))
                cells[which + "_" + name] = got
        lb, ub = tx.pair_cell_bounds_torch(
            stat, cells["lo_a"], cells["hi_a"], cells["lo_b"], cells["hi_b"],
            torch.from_numpy(pair_rois), torch.from_numpy(rb),
            torch.from_numpy(cb))
        assert lb.dtype == ub.dtype == torch.float64
        jlb, jub = jx.pair_cell_bounds_jnp(
            stat, *(jnp.asarray(cells[k].numpy()) for k in
                    ("lo_a", "hi_a", "lo_b", "hi_b")),
            jnp.asarray(pair_rois), jnp.asarray(rb), jnp.asarray(cb))
        _eq(lb, np.asarray(jlb, np.float64))
        _eq(ub, np.asarray(jub, np.float64))
        hlb, hub = tx.pair_cell_bounds(
            cfg, stat, *(cells[k].numpy().astype(np.int64) for k in
                         ("lo_a", "hi_a", "lo_b", "hi_b")), pair_rois)
        _eq(lb, hlb)
        _eq(ub, hub)


@pytest.mark.parametrize("stat", ["inter", "union", "diff"])
def test_device_pair_bounds_equal_host_and_contain_exact(db, stat):
    _, t, rois = db
    for roi in (None, "provided", (5, 3, 29, 27)):
        term = tx.PairTerm(stat, 1, 2, 0.5, 0.25, roi)
        run = PairFilterRun(t, tx.Cmp(term, ">", 0.0), provided_rois=rois,
                            backend="device")
        lb, ub = run.expr_bounds(term)
        hlb, hub = run.ctx.bounds(term)     # the host numpy cell combine
        _eq(lb, hlb)
        _eq(ub, hub)
        exact = run.ctx.exact(term, np.arange(run.n))
        assert np.all(lb <= exact) and np.all(exact <= ub)


# ---------------------------------------------------------------------------
# pair plans and SQL: port host / device / naive scan vs the JAX package
# ---------------------------------------------------------------------------

OFFGRID = (3, 5, 29, 31)       # a grid-misaligned ROI: the CHI leaves residue
PLANS = [
    LogicalPlan(order_by=tx.pair_iou(1, 2, 0.6, 0.6), k=5, desc=False),
    LogicalPlan(order_by=tx.pair_iou(1, 2, 0.6, 0.6, OFFGRID), k=5,
                desc=False),
    LogicalPlan(predicate=tx.Cmp(tx.PairTerm("diff", 1, 2, 0.5, 0.5, None),
                                 ">", 30.0),
                order_by=tx.PairTerm("inter", 1, 2, 0.5, 0.5, "provided"),
                k=6, desc=True),
    LogicalPlan(predicate=tx.Cmp(tx.PairTerm("union", 1, 2, 0.4, 0.4, None),
                                 "<", 400.0)),
    LogicalPlan(predicate=tx.Cmp(
        tx.BinOp("/", tx.PairTerm("diff", 1, 2, 0.6, 0.6, "provided"),
                 tx.RoiArea("provided")), ">", 0.1)),
    LogicalPlan(order_by=tx.BinOp("-", tx.PairTerm("diff", 2, 1, 0.3, 0.7,
                                                   OFFGRID),
                                  tx.PairTerm("inter", 2, 1, 0.3, 0.7, None)),
                k=7, desc=True),
    LogicalPlan(agg="AVG", agg_expr=tx.pair_iou(1, 2, 0.6, 0.6)),
    LogicalPlan(agg="MAX", agg_expr=tx.PairTerm("diff", 1, 2, 0.5, 0.5,
                                                "provided")),
]
SQL = {
    "pair_iou_topk": jq.SCENARIO6_DISCREPANCY,
    "pair_iou_roi": "SELECT image_id FROM MasksDatabaseView ORDER BY "
                    "IOU(saliency, attention, 0.6, 0.6, (3, 5, 29, 31)) ASC "
                    "LIMIT 5;",
    "pair_diff_filter": "SELECT image_id FROM MasksDatabaseView WHERE "
                        "PAIR_DIFF(saliency, attention, 0.6, 0.6, roi) > 20;",
    "pair_filtered_topk": "SELECT image_id FROM MasksDatabaseView WHERE "
                          "PAIR_DIFF(saliency, attention, 0.6, 0.6, roi) > 10 "
                          "ORDER BY PAIR_DIFF(saliency, attention, 0.6, 0.6, "
                          "roi) DESC LIMIT 5;",
}


def _to_jax(node):
    """The same expression / predicate built from the JAX package's IR."""
    if not isinstance(node, (tx.Node, tx.Pred)):
        return node
    cls = getattr(jx, type(node).__name__)
    return cls(**{f.name: _to_jax(getattr(node, f.name))
                  for f in dataclasses.fields(node)})


def _to_jax_plan(plan):
    return jplan.LogicalPlan(**{f.name: _to_jax(getattr(plan, f.name))
                                for f in dataclasses.fields(plan)})


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


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_pair_plans_match_jax_on_every_path(db, i):
    j, t, rois = db
    plan, jp = PLANS[i], _to_jax_plan(PLANS[i])
    for be in ("host", "device"):
        got = run_plan(t, plan, provided_rois=rois, verify_batch=4,
                       backend=be)
        _same(got, jplan.run_plan(j, jp, provided_rois=rois, verify_batch=4,
                                  backend=be), f"{i}/{be}")
    naive = run_plan(t, plan, provided_rois=rois, use_index=False)
    _same(naive, jplan.run_plan(j, jp, provided_rois=rois, use_index=False),
          f"{i}/naive")
    # and indexed == naive (ids and scores) on these plans
    _same(got, naive, f"{i}/device vs naive", stats=False)


@pytest.mark.parametrize("backend", ["host", "device", "naive"])
@pytest.mark.parametrize("name", list(SQL))
def test_pair_sql_matches_jax(db, name, backend):
    j, t, rois = db
    kw = (dict(use_index=False) if backend == "naive"
          else dict(backend=backend, verify_batch=4))
    got = tq.run(SQL[name], t, provided_rois=rois, **kw)
    _same(got, jq.run(SQL[name], j, provided_rois=rois, **kw),
          f"{name}/{backend}")
    ids = got[0][0] if isinstance(got[0], tuple) else got[0]
    assert len(ids) > 0
    if backend != "naive":
        assert got[1].n_verified > 0


def test_packed_pair_answers_equal_the_float_store(packed_db):
    """A float store of the same binary masks gives the packed store's ids
    and scores on both backends."""
    _, t, rois = packed_db
    masks, meta, _ = _pair_data()
    fl = TStore.create_memory((masks > 0.5).astype(np.float32), meta, t.cfg,
                              device="cpu")
    for name, sql in SQL.items():
        for be in ("host", "device"):
            _same(tq.run(sql, t, provided_rois=rois, backend=be),
                  tq.run(sql, fl, provided_rois=rois, backend=be),
                  f"{name}/{be}", stats=False)


@pytest.mark.parametrize("packed", [False, True])
def test_append_of_a_new_pair_is_seen_by_the_next_query(packed):
    """Image 30 arrives after the first query: its saliency and attention
    masks are disjoint, so it enters the lowest-IoU ranking with IoU 0 on
    every path, as in the JAX package."""
    j, t, rois = _stores(packed)
    sql = SQL["pair_iou_topk"]
    for be in ("host", "device"):
        tq.run(sql, t, backend=be)          # pins the device residency
    sal = np.zeros((1, H, W), np.float32)
    att = np.zeros((1, H, W), np.float32)
    sal[0, :16] = 0.9
    att[0, 16:] = 0.9
    meta = np.zeros(2, MASK_META_DTYPE)
    meta["mask_id"] = [1000, 1001]
    meta["image_id"] = [N_IMG, N_IMG]
    meta["mask_type"] = [1, 2]
    new = np.concatenate([sal, att])
    if packed:
        new = (new > 0.5).astype(np.float32)
    assert t.append(new, meta) == j.append(new, meta)
    for be in ("host", "device", "naive"):
        kw = (dict(use_index=False) if be == "naive"
              else dict(backend=be, verify_batch=4))
        got = tq.run(sql, t, **kw)
        _same(got, jq.run(sql, j, **kw), f"append/{be}")
        ids, scores = got[0]
        assert N_IMG in ids and scores[list(ids).index(N_IMG)] == 0.0


def _dispatches(kernel):
    snap = REGISTRY.snapshot().get("masksearch_kernel_launches_total", {})
    return snap.get(f"kernel={kernel}", 0.0)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_pair_kernel_one_dispatch_per_spec_per_batch(db, backend):
    """IoU's inter and union share one (ta, tb, roi) spec, so a ranking by
    IoU dispatches the pair kernel once per verification batch; a second
    spec adds one dispatch per batch."""
    _, t, rois = db
    kernel = "pair_counts_packed" if t.packed else "pair_counts"
    for expr, specs in ((tx.pair_iou(1, 2, 0.6, 0.6), 1),
                        (tx.pair_iou(1, 2, 0.6, 0.6) +
                         tx.PairTerm("diff", 1, 2, 0.3, 0.6, "provided"), 2)):
        run = PairTopKRun(t, expr, provided_rois=rois, verify_batch=4,
                          backend=backend)
        run.target(6)
        before = _dispatches(kernel)
        n_batches = 0
        while not run.finished():
            batch = run.take_batch()
            if not len(batch):
                break
            run.self_verify(batch)
            n_batches += 1
        assert n_batches >= 2
        assert _dispatches(kernel) - before == specs * n_batches


def test_device_pair_step_reads_resident_words_in_place(packed_db,
                                                       monkeypatch):
    """On a packed store the device backend's pair step hands the kernel
    the resident words with both roles' positions and gathers nothing; the
    answers stay those of the host backend."""
    _, t, rois = packed_db
    resident = get_backend(t, "device")._masks
    seen = []
    plain = ops.pair_counts_packed.plain

    def spy(a, b, *args):
        seen.append((a, b) + tuple(args[3:]))
        return plain(a, b, *args)

    def no_gather(*args, **kwargs):
        raise AssertionError("the pair step gathered rows")
    want = {name: tq.run(SQL[name], t, provided_rois=rois, backend="host")
            for name in ("pair_iou_topk", "pair_diff_filter")}
    monkeypatch.setattr(ops.pair_counts_packed, "plain", spy)
    monkeypatch.setattr(torch.Tensor, "index_select", no_gather)
    for name, (wres, _) in want.items():
        got, stats = tq.run(SQL[name], t, provided_rois=rois,
                            backend="device")
        _eq(got[0] if isinstance(got, tuple) else got,
            wres[0] if isinstance(wres, tuple) else wres)
        assert stats.n_verified > 0
    monkeypatch.undo()
    assert seen
    for a, b, pos_a, pos_b in seen:
        assert a is resident and b is resident
        assert len(pos_a) == len(pos_b) > 0


def test_pair_runs_refuse_plans_without_pair_terms(float_db):
    _, t, _ = float_db
    with pytest.raises(ValueError, match="pair run"):
        PairTopKRun(t, tx.CP(None, 0.5, 1.0))
    assert isinstance(TopKRun(t, tx.CP(None, 0.5, 1.0)).ctx,
                      tx.MaskEvalContext)


# ---------------------------------------------------------------------------
# a fault of the reference, inherited by design: 0/0 in interval division
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,naive_ids,indexed_ids", [
    (1, [8], [11]),
    (3, [8, 11, 29], [11, 29, 19]),
])
def test_zero_over_zero_ranking_reproduces_the_reference(float_db, k,
                                                         naive_ids,
                                                         indexed_ids):
    """``union / inter`` ascending: image 8's ratio is 0/0.  The JAX
    package's naive scan ranks it first, its indexed pair path drops it
    (interval division over a zero denominator; ROADMAP §3).  The port
    copies the reference's interval and exact arithmetic, so it returns
    the same two answers, not a repaired one."""
    j, t, rois = float_db
    expr = tx.BinOp("/", tx.PairTerm("union", 1, 2, 0.5, 0.25, None),
                    tx.PairTerm("inter", 1, 2, 0.5, 0.25, None))
    plan = LogicalPlan(order_by=expr, k=k, desc=False)
    jp = _to_jax_plan(plan)
    naive = run_plan(t, plan, provided_rois=rois, use_index=False)
    _same(naive, jplan.run_plan(j, jp, provided_rois=rois, use_index=False),
          "naive")
    assert list(naive[0][0]) == naive_ids
    for be in ("host", "device"):
        got = run_plan(t, plan, provided_rois=rois, verify_batch=4,
                       backend=be)
        _same(got, jplan.run_plan(j, jp, provided_rois=rois, verify_batch=4,
                                  backend=be), be)
        assert list(got[0][0]) == indexed_ids
