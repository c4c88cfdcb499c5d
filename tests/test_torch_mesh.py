"""PyTorch port: the mesh engine vs the JAX package.

The JAX package's mesh runs in this process on its one CPU device; the
port's runs on one CPU shard and on eight (``devices=["cpu"] * 8``: logical
shards on one device, as the card runs a mesh of ``cuda:0`` repeated).  The
same numpy inputs go through each of the 15 step factories, through
``DistributedEngine`` and through ``MeshBackend`` plans on float, packed
and pair stores.  Every output is an int32 count, a float32 IoU computed
from counts, or a float64 score built from counts, so equality is exact.
The local top-k candidates of the bound-driven top-k step depend on the
shard count; they are held to a numpy model of stable per-shard top-k.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import CHIConfig as JCfg
from repro.core import MaskStore as JStore
from repro.core import distributed as jdist
from repro.core import queries as jq
from repro.core.backend import get_backend as jget_backend
from repro.core.chi import build_chi_np
from repro.core.packing import pack_masks
from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from repro_torch.core import CHIConfig as TCfg
from repro_torch.core import MaskStore as TStore
from repro_torch.core import StaleRunError
from repro_torch.core import distributed as tdist
from repro_torch.core import queries as tq
from repro_torch.core.backend import MeshBackend, get_backend, host_backend
from repro_torch.core.engine import TopKRun
from repro_torch.core.exprs import AggCP, BinOp, Cmp, CP, RoiArea
from repro_torch.core.plan import LogicalPlan, run_plan
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.obs.metrics import REGISTRY

STATS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds",
         "n_dropped_masks", "bytes_loaded", "bytes_saved", "chi_bytes")
SHARDS = (1, 8)


def _jmesh():
    """The JAX package's in-process mesh: every JAX device (one CPU)."""
    return jdist.make_mesh((len(jax.devices()),), ("data",))


def _tmesh(shards):
    if shards == 8:
        return tdist.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    return tdist.make_mesh((1,), ("data",), ["cpu"])


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, label=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=label)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_mesh_shapes_and_placement(monkeypatch):
    mesh = _tmesh(8)
    assert mesh.size == 8 and mesh.shape == {"data": 2, "model": 4}
    assert tdist.db_axes(mesh) == ("data", "model")
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert tdist.make_mesh((1,), ("data",), ["cpu"]).devices == (
        torch.device("cpu"),)
    # with no card visible a mesh without devices raises: nothing falls
    # back to the CPU on its own
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdist.make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()
    with pytest.raises(ValueError):
        tdist.make_mesh((2, 4), ("data", "model"), ["cpu"] * 4)
    x = np.arange(16 * 3, dtype=np.int32).reshape(16, 3)
    sh = tdist.device_put(x, tdist.row_sharding(mesh, 2))
    assert sh.shape == (16, 3) and len(sh.shards) == 8
    for i, s in enumerate(sh.shards):
        _eq(s, x[2 * i:2 * i + 2])
    rep = tdist.device_put(x, tdist.replicated(mesh))
    assert rep.shape == (16, 3) and all(_np(s).tolist() == x.tolist()
                                        for s in rep.shards)
    # packed words placed as their int32 bit view
    words = np.array([[0xFFFFFFFF, 1]] * 8, np.uint32)
    sh = tdist.device_put(words, tdist.row_sharding(mesh, 2))
    assert sh.shards[0].dtype == torch.int32
    _eq(sh.shards[3].numpy().view(np.uint32), words[3:4])
    with pytest.raises(ValueError):
        tdist.device_put(x[:12], tdist.row_sharding(mesh, 2))


def test_steps_count_the_host_bytes_they_place():
    mesh = _tmesh(8)
    step = tdist.make_verify_step(mesh)
    masks = np.zeros((16, 8, 8), np.float32)
    rois = np.zeros((16, 4), np.int32)
    before = mesh.placed_bytes
    step(masks, rois, np.float32(0.5), np.float32(1.0))
    assert mesh.placed_bytes - before == masks.nbytes + rois.nbytes
    placed = tdist.device_put(masks, tdist.row_sharding(mesh, 3))
    before = mesh.placed_bytes
    step(placed, rois, np.float32(0.5), np.float32(1.0))
    assert mesh.placed_bytes - before == rois.nbytes


# ---------------------------------------------------------------------------
# the 15 step factories, port vs JAX on the same inputs
# ---------------------------------------------------------------------------

N, SH, SW, S = 16, 32, 40, 2   # rows, mask side, shard-friendly widths


@functools.lru_cache(maxsize=None)
def _step_data():
    rng = np.random.default_rng(21)
    cfg = dict(grid=4, num_bins=8, height=SH, width=SW)
    boxes = object_boxes(N, SH, SW, seed=22)
    masks, _ = saliency_masks(N, SH, SW, seed=23, boxes=boxes)
    masks = masks.astype(np.float32)
    masks[:, ::5] = np.float32(0.5)           # pixels on a threshold
    tables = build_chi_np(masks, JCfg(**cfg))
    binary = (masks > 0.5).astype(np.float32)
    packed = pack_masks(binary)
    rois = np.concatenate([boxes[:N - 3],
                           [[0, 0, SH, SW], [4, 4, 4, 9], [-3, 2, 40, 50]]]
                          ).astype(np.int32)
    rois_q = np.stack([rois, np.roll(rois, 3, axis=0),
                       np.tile([2, 3, 30, 37], (N, 1))]).astype(np.int32)
    lvs = np.array([0.5, 0.2, 0.0], np.float32)
    uvs = np.array([1.0, 0.6, 3.4e38], np.float32)
    plvs = np.array([0.5, -0.5, 0.0], np.float32)
    puvs = np.array([1.5, 0.5, 1.0], np.float32)
    decided = (rng.random((3, N)) < 0.3).astype(np.int32)
    lb = (rng.integers(0, 50, (3, N)) * decided).astype(np.int32)
    pes = rng.integers(0, 6, N).astype(np.float32)   # ties on purpose
    definite = rng.random(N) < 0.7
    tcfg = TCfg(**cfg)
    ks = tdist.value_ks(tcfg, 0.3, 0.7)
    rb = np.asarray(tcfg.row_bounds, np.int32)
    cb = np.asarray(tcfg.col_bounds, np.int32)
    lb_, ub_ = (np.asarray(x) for x in jdist.make_chi_bounds_step(_jmesh())(
        tables, rois, rb, cb, ks))
    both = np.intersect1d(lb_, ub_)
    return dict(
        cfg=tcfg, masks=masks, tables=tables, packed=packed, rois=rois,
        rois_q=rois_q, lvs=lvs, uvs=uvs, plvs=plvs, puvs=puvs,
        decided=decided, lb=lb, pes=pes, definite=definite,
        groups=masks.reshape(N // S, S, SH, SW),
        pgroups=packed.reshape(N // S, S, SH, -1),
        grois=rois[::S].copy(), pair_a=masks[::2].copy(),
        pair_b=masks[1::2].copy(), ppair_a=packed[::2].copy(),
        ppair_b=packed[1::2].copy(), prois=rois[::2].copy(),
        rb=rb, cb=cb, ks=ks,
        # a fractional threshold half a count above a value that is both
        # some row's lower bound and some row's upper bound
        frac=float(both[len(both) // 2]) + 0.5,
        pks=np.array([2, 1, 5, 4], np.int32),
        ids=np.arange(N, dtype=np.int32))


def _case(name):
    """(factory name, factory args, step arguments)."""
    d = _step_data()
    f32 = np.float32
    if name.startswith("filter_bounds"):
        kind, op = name.split(":")
        thr = d["frac"] if kind == "filter_bounds_frac" else 120
        return ("make_filter_bounds_step", (op,),
                (d["tables"], d["rois"], d["rb"], d["cb"], d["ks"], thr))
    if name.startswith("pair_cells"):
        return ("make_pair_cells_step", (name.split(":")[1],),
                (d["tables"][::2], d["tables"][1::2], d["prois"], d["pks"],
                 d["rb"], d["cb"]))
    return {
        "verify": ("make_verify_step", (),
                   (d["masks"], d["rois"], f32(0.5), f32(1.0))),
        "chi_bounds": ("make_chi_bounds_step", (),
                       (d["tables"], d["rois"], d["rb"], d["cb"], d["ks"])),
        "topk_select": ("make_topk_select_step", (5,),
                        (d["pes"], d["definite"], d["ids"])),
        "mask_agg": ("make_mask_agg_step", (),
                     (d["groups"], d["grois"], f32(0.5))),
        "cp_multi": ("make_cp_multi_step", (),
                     (d["masks"], d["rois_q"], d["lvs"], d["uvs"])),
        "pair_counts": ("make_pair_counts_step", (),
                        (d["pair_a"], d["pair_b"], d["prois"], f32(0.6),
                         f32(0.4))),
        "verify_packed": ("make_verify_packed_step", (),
                          (d["packed"], d["rois"], f32(0.5), f32(1.5))),
        "cp_multi_packed": ("make_cp_multi_packed_step", (),
                            (d["packed"], d["rois_q"], d["plvs"],
                             d["puvs"])),
        "mask_agg_packed": ("make_mask_agg_packed_step", (),
                            (d["pgroups"], d["grois"], f32(0.5))),
        "pair_counts_packed": ("make_pair_counts_packed_step", (),
                               (d["ppair_a"], d["ppair_b"], d["prois"],
                                f32(0.5), f32(-0.5))),
        "fused_verify": ("make_fused_verify_step", (),
                         (d["packed"], d["rois_q"], d["plvs"], d["puvs"],
                          d["decided"], d["lb"])),
        "iou_agg": ("make_iou_agg_step", (),
                    (d["groups"], d["grois"], f32(0.35))),
    }[name]


STEP_CASES = ([f"{kind}:{op}" for kind in ("filter_bounds",
                                           "filter_bounds_frac")
               for op in ("<", "<=", ">", ">=")]
              + ["pair_cells:" + s for s in ("inter", "union", "diff")]
              + ["verify", "chi_bounds", "topk_select", "mask_agg",
                 "cp_multi", "pair_counts", "verify_packed",
                 "cp_multi_packed", "mask_agg_packed", "pair_counts_packed",
                 "fused_verify", "iou_agg"])


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    factory, fargs, args = _case(name)
    out = getattr(jdist, factory)(_jmesh(), *fargs)(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", STEP_CASES)
def test_step_matches_jax(name, shards):
    factory, fargs, args = _case(name)
    got = getattr(tdist, factory)(_tmesh(shards), *fargs)(*args)
    want = _jax_step(name)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w, name)
    elif name == "iou_agg":       # float32, bit for bit
        assert got.dtype == torch.float32
        _eq(_np(got).view(np.int32), want.view(np.int32), name)
        assert 0 < np.count_nonzero(want) < len(want)
    else:
        _eq(got, want, name)


@pytest.mark.parametrize("op", ["<", ">="])
def test_fractional_threshold_is_not_truncated(op):
    """The step compares int32 bounds with the threshold as given: for
    ``<`` (reject lb >= t) and ``>=`` (accept lb >= t) a threshold of
    v + 0.5 decides rows with a bound of v otherwise than v would, so the
    ``filter_bounds_frac`` cases see a step that truncates it."""
    factory, fargs, args = _case("filter_bounds_frac:" + op)
    frac = _jax_step("filter_bounds_frac:" + op)
    trunc = getattr(jdist, factory)(_jmesh(), *fargs)(
        *args[:-1], int(args[-1]))
    assert args[-1] != int(args[-1])
    assert not np.array_equal(frac[1], np.asarray(trunc[1]))
    got = tdist.make_filter_bounds_step(_tmesh(8), op)(*args)
    for g, w in zip(got, frac):
        _eq(g, w, op)


def _local_topk_model(score, ids, k, shards):
    """Per shard, the k best of ``score`` with ties to the lower index (a
    stable descending sort), concatenated in shard order."""
    vals, out_ids = [], []
    for s, i in zip(np.split(score, shards), np.split(ids, shards)):
        order = np.argsort(-s.astype(np.int64), kind="stable")[:k]
        vals.append(s[order])
        out_ids.append(i[order])
    return np.concatenate(vals), np.concatenate(out_ids)


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("shards", SHARDS)
def test_topk_step_matches_jax_and_a_stable_local_topk(shards, desc):
    d = _step_data()
    args = (d["tables"], d["rois"], d["rb"], d["cb"], d["ks"], d["ids"] + 7)
    step, width = tdist.make_topk_step(_tmesh(shards), 2, desc)
    jstep, jwidth = jdist.make_topk_step(_jmesh(), 2, desc)
    vals, ids, tau, surv = step(*args)
    jvals, jids, jtau, jsurv = jstep(*args)
    assert width == 2 * shards and len(vals) == len(ids) == width
    assert int(tau) == int(jtau)
    _eq(surv, jsurv)
    lb, ub = tdist.make_chi_bounds_step(_tmesh(1))(*args[:5])
    score = _np(ub) if desc else -_np(lb)
    mvals, mids = _local_topk_model(score, args[5], 2, shards)
    _eq(vals, mvals)
    _eq(ids, mids)
    if shards == 1:           # one shard: lax.top_k's own candidates
        _eq(vals, jvals)
        _eq(ids, jids)


# ---------------------------------------------------------------------------
# DistributedEngine (test_distributed.py::test_distributed_query_engine)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
def test_distributed_engine_matches_jax(shards):
    n, h, w = 64, 64, 64
    jcfg = JCfg(grid=8, num_bins=8, height=h, width=w)
    cfg = TCfg(grid=8, num_bins=8, height=h, width=w)
    masks = saliency_masks(n, h, w, seed=3)[0]
    tables = build_chi_np(masks, jcfg)
    rois = np.tile([8, 8, 56, 56], (n, 1)).astype(np.int32)
    mesh = _tmesh(shards)
    eng = tdist.DistributedEngine(mesh, cfg)
    jeng = jdist.DistributedEngine(_jmesh(), jcfg)
    t_sh = tdist.device_put(tables, tdist.row_sharding(mesh, 4))
    r_sh = tdist.device_put(rois, tdist.row_sharding(mesh, 2))
    lv, uv, thr = 0.5, 1.0, 200
    got = eng.filter_bounds(t_sh, r_sh, lv, uv, "<", thr)
    for g, w_ in zip(got, jeng.filter_bounds(tables, rois, lv, uv, "<", thr)):
        _eq(g, w_)
    accept, undecided, counts = (_np(x) for x in got)
    from repro.core.cp import cp_exact_np
    exact = np.array([cp_exact_np(m, rois[0], lv, uv) for m in masks])
    assert np.all(exact[accept] < thr)
    assert np.all(exact[~(accept | undecided)] >= thr)
    assert int(counts[1]) < n, "bounds must decide something on blobby masks"

    vals, ids, tau, surv = eng.topk_candidates(t_sh, r_sh, lv, uv, k=5)
    _, _, jtau, jsurv = jeng.topk_candidates(tables, rois, lv, uv, k=5)
    assert int(tau) == int(jtau)
    _eq(surv, jsurv)
    _, ub = tdist.make_chi_bounds_step(mesh)(
        tables, rois, cfg.row_bounds, cfg.col_bounds,
        tdist.value_ks(cfg, lv, uv))
    mvals, mids = _local_topk_model(_np(ub), np.arange(n), 5, shards)
    _eq(vals, mvals)
    _eq(ids, mids)
    top5 = set(np.argsort(-exact, kind="stable")[:5])
    assert top5.issubset(set(np.nonzero(_np(surv))[0]))
    assert _np(surv).sum() < n, "top-k pruning must drop candidates"

    m_sh = tdist.device_put(masks, tdist.row_sharding(mesh, 3))
    got = eng.verify(m_sh, r_sh, lv, uv)
    _eq(got, exact)
    _eq(got, jeng.verify(masks, rois, lv, uv))


# ---------------------------------------------------------------------------
# MeshBackend plans (test_distributed.py::
# test_mesh_backend_multi_device_matches_host), float, packed and pair
# ---------------------------------------------------------------------------


def _db52(packed=False):
    b, h, w = 52, 64, 64          # 52 % 8 != 0 -> padding exercised
    rois = object_boxes(b, h, w, seed=2)
    masks, _ = saliency_masks(b, h, w, seed=1, attacked_fraction=0.25,
                              boxes=rois)
    if packed:
        masks = (masks > 0.5).astype(np.float32)
    meta = np.zeros(b, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(b) + 100
    meta["image_id"] = np.arange(b) // 2
    meta["mask_type"] = np.arange(b) % 2 + 1
    cfg = dict(grid=8, num_bins=8, height=h, width=w)
    return (JStore.create_memory(masks, meta, JCfg(**cfg), packed=packed),
            TStore.create_memory(masks, meta, TCfg(**cfg), packed=packed,
                                 device="cpu"), rois)


@pytest.fixture(scope="module")
def db52():
    return _db52()


@pytest.fixture(scope="module")
def packed52():
    return _db52(packed=True)


def _same(got, want, label, stats=STATS):
    (gres, gst), (wres, wst) = got, want
    if isinstance(wres, tuple):
        _eq(gres[0], wres[0], label)
        _eq(gres[1], wres[1], label)
    elif isinstance(wres, float):
        assert gres == wres or (np.isnan(gres) and np.isnan(wres)), label
    else:
        _eq(gres, wres, label)
    for f in stats:
        assert getattr(gst, f) == getattr(wst, f), (label, f)


PLANS52 = [
    LogicalPlan(predicate=Cmp(CP(None, 0.5, 1.0), ">", 500.0)),
    LogicalPlan(order_by=CP(None, 0.2, 0.6), k=7),
    LogicalPlan(predicate=Cmp(CP("provided", 0.8, 1.0), ">", 50.0),
                order_by=BinOp("/", CP(None, 0.2, 0.6), RoiArea(None)),
                k=5, desc=False),
    LogicalPlan(agg="MAX", agg_expr=CP(None, 0.4, 0.8)),
    LogicalPlan(select="image_id", order_by=AggCP("union", 0.8, None), k=5),
]


def _jplan(plan):
    from test_torch_pair import _to_jax_plan
    return _to_jax_plan(plan)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("i", range(len(PLANS52)))
def test_mesh_backend_plans_match_jax(db52, i, shards):
    j, t, rois = db52
    be = MeshBackend(t, _tmesh(shards))
    got = run_plan(t, PLANS52[i], provided_rois=rois, verify_batch=8,
                   backend=be)
    jp = _jplan(PLANS52[i])
    from repro.core.plan import run_plan as jrun_plan
    _same(got, jrun_plan(j, jp, provided_rois=rois, verify_batch=8,
                         backend="mesh"), f"{i}/{shards}")
    # the host loads the verified bytes; the mesh reads resident rows
    _same(got, jrun_plan(j, jp, provided_rois=rois, verify_batch=8,
                         backend="host"), f"{i}/{shards}/host",
          stats=("n_candidates", "n_decided_by_bounds", "n_verified"))


PACKED_SQL = [
    "SELECT mask_id FROM MasksDatabaseView WHERE "
    "CP(mask, roi, (0.5, 1.5)) / AREA(roi) < 0.5;",
    "SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, (0.5, 1.5)) "
    "> 20 AND NOT CP(mask, full_img, (0.5, 1.5)) < 60 ORDER BY "
    "CP(mask, (3, 5, 29, 31), (0.5, 1.5)) DESC LIMIT 8;",
    jq.SCENARIO3_IOU,
    jq.SCENARIO6_DISCREPANCY,
    "SELECT image_id FROM MasksDatabaseView WHERE "
    "PAIR_DIFF(saliency, attention, 0.6, 0.6, roi) > 20;",
]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("i", range(len(PACKED_SQL)))
def test_eight_shard_sql_matches_jax_mesh(db52, packed52, i, packed):
    """Packed CP and MASK_AGG queries, and pair queries on both tiers
    (types 1 and 2 alternate per image), on eight shards."""
    j, t, rois = packed52 if packed else db52
    be = MeshBackend(t, _tmesh(8))
    got = tq.run(PACKED_SQL[i], t, provided_rois=rois, backend=be,
                 verify_batch=5)
    want = jq.run(PACKED_SQL[i], j, provided_rois=rois, backend="mesh",
                  verify_batch=5)
    _same(got, want, f"{i}/packed={packed}")
    ids = got[0][0] if isinstance(got[0], tuple) else got[0]
    assert len(ids) > 0 and got[1].n_verified > 0


def _dispatches(kernel):
    snap = REGISTRY.snapshot().get("masksearch_kernel_launches_total", {})
    return snap.get(f"kernel={kernel}", 0.0)


@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_reaches_distributed_steps(db52, shards):
    """test_backend_equivalence.py's acceptance: the step functions are the
    mesh backend's physical layer; each kernel runs once per shard."""
    _, t, rois = db52
    be = MeshBackend(t, _tmesh(shards))
    calls = []
    original = be._verify_step

    def spying(*a, **kw):
        calls.append(1)
        return original(*a, **kw)

    be._verify_step = spying
    before = _dispatches("cp_count")
    _, stats = run_plan(t, LogicalPlan(order_by=CP(None, 0.2, 0.6), k=5),
                        provided_rois=rois, verify_batch=4, backend=be)
    assert calls and len(calls) == stats.n_rounds
    assert _dispatches("cp_count") - before == shards * stats.n_rounds


@pytest.mark.parametrize("shards", SHARDS)
def test_packed_mesh_uses_fused_verify_step(packed52, shards):
    _, t, rois = packed52
    be = MeshBackend(t, _tmesh(shards))
    assert be._packed and be._fused_verify_step is not None
    calls = []
    original = be._fused_verify_step

    def spying(*a, **kw):
        calls.append(1)
        return original(*a, **kw)

    be._fused_verify_step = spying
    before = _dispatches("fused_bounds_verify")
    _, stats = run_plan(t, LogicalPlan(order_by=CP((3, 5, 29, 31), 0.5, 1.5),
                                       k=5),
                        provided_rois=rois, verify_batch=4, backend=be)
    assert stats.n_verified > 0
    assert len(calls) == stats.n_rounds
    assert (_dispatches("fused_bounds_verify") - before
            == shards * stats.n_rounds)


def test_packed_single_term_verify_reaches_cp_count_packed(packed52):
    """A packed store's engine verifies through the megakernel; the
    single-descriptor packed step answers a direct ``verify_counts``."""
    from repro_torch.core.exprs import MaskEvalContext
    _, t, rois = packed52
    batch = np.arange(0, 52, 3)
    term = CP("provided", 0.5, 1.5)
    want = host_backend().verify_counts(
        MaskEvalContext(t, np.arange(52), rois), batch, [term])
    before = _dispatches("cp_count_packed")
    got = MeshBackend(t, _tmesh(8)).verify_counts(
        MaskEvalContext(t, np.arange(52), rois), batch, [term])
    _eq(got[term], want[term])
    assert _dispatches("cp_count_packed") - before == 8


@pytest.mark.parametrize("desc", [True, False])
def test_topk_frontier_exact_under_f32_collisions_on_eight_shards(db52,
                                                                  desc):
    """Scores closer than one float32 ulp collapse in the sharded top-k;
    τ is resolved at float64, so the frontier equals the host's and the
    JAX mesh backend's."""
    j, t, _ = db52
    be = MeshBackend(t, _tmesh(8))
    base = np.array([1.0, 1.0 + 1e-10, 1.0 + 2e-10, 0.5, 2.0])
    lb = base if desc else base - 1e-11
    ub = base + 1e-11 if desc else base
    patterns = [(np.ones(5, bool), np.ones(5, bool), range(1, 6)),
                (np.array([True, False, True, True, True]),
                 np.array([True, True, True, False, True]), (1, 2, 3))]
    for definite, possible, ks in patterns:
        for k in ks:
            want = host_backend().topk_candidates(lb, ub, k, desc, definite,
                                                  possible)
            got = be.topk_candidates(lb, ub, k, desc, definite, possible)
            _eq(got, want, f"k={k}")
            _eq(got, jget_backend(j, "mesh").topk_candidates(
                lb, ub, k, desc, definite, possible), f"k={k}")


# ---------------------------------------------------------------------------
# mutations (test_mutation.py's mesh legs)
# ---------------------------------------------------------------------------


def _mut_data(n, seed=0, id_base=0):
    """test_mutation.py's data: 32x32 masks, three mask types."""
    boxes = object_boxes(n, 32, 32, seed=seed + 1)
    masks, _ = saliency_masks(n, 32, 32, seed=seed, attacked_fraction=0.3,
                              boxes=boxes)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = id_base + np.arange(n)
    meta["image_id"] = (id_base + np.arange(n)) // 2
    meta["mask_type"] = np.arange(n) % 3 + 1
    return np.asarray(masks, np.float32), meta


def _mutable(n=18, seed=0):
    masks, meta = _mut_data(n, seed)
    cfg = dict(grid=4, num_bins=8, height=32, width=32)
    return (JStore.create_memory(masks, meta, JCfg(**cfg)),
            TStore.create_memory(masks, meta, TCfg(**cfg), device="cpu"),
            masks)


def _partial_run(store, **kw):
    run = TopKRun(store, CP(None, 0.2, 0.6), verify_batch=2, **kw)
    run.target(6)
    batch = run.take_batch()
    if len(batch):
        run.self_verify(batch)
    return run


@pytest.mark.parametrize("backend", ["device", "mesh"])
def test_stale_run_on_refreshed_backend_raises(backend):
    _, store, masks = _mutable()
    run = _partial_run(store, backend=backend)
    store.update([0], np.clip(masks[:1] * 0.5, 0, 1))
    assert not run.resumable()
    with pytest.raises(StaleRunError):
        run.ensure(6)


def test_stale_run_error_surfaces_as_conflict():
    """A delete under a partial run reports StaleRunError; a fresh plan
    over the mutated store answers as the JAX package on every backend,
    the mesh on one shard and on eight."""
    j, store, _ = _mutable()
    run = _partial_run(store, backend="device")
    store.delete([0])
    j.delete([0])
    with pytest.raises(StaleRunError):
        run.ensure(6)
    plan = LogicalPlan(predicate=Cmp(CP(None, 0.2, 0.6), ">", 100.0))
    from repro.core.plan import run_plan as jrun_plan
    jp = _jplan(plan)
    for backend in ("host", "device", "mesh",
                    MeshBackend(store, _tmesh(8))):
        name = backend if isinstance(backend, str) else "mesh"
        _same(run_plan(store, plan, backend=backend),
              jrun_plan(j, jp, backend=name), str(backend))


def test_mesh_follows_appends_updates_and_deletes_like_jax():
    """The mesh re-pins its host arrays per epoch: append, update and delete
    between queries, on eight shards, answer as the JAX mesh does."""
    j, t, masks = _mutable(16, seed=4)
    extra, meta = _mut_data(8, seed=9, id_base=100)
    be = MeshBackend(t, _tmesh(8))
    sql = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
           "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 6;")
    steps = [lambda s: s.append(extra, meta),
             lambda s: s.update([3, 101], masks[[5, 6]] * 0.9),
             lambda s: s.delete([0, 9, 104])]
    for step in [None] + steps:
        if step is not None:
            step(j)
            step(t)
        _same(tq.run(sql, t, backend=get_backend(t, be)),
              jq.run(sql, j, backend="mesh"), f"epoch {t.epoch}")
    assert be._epoch == t.epoch == 3
