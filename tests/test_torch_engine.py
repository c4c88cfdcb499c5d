"""PyTorch port: the main path end to end vs the JAX package.

The same 64-mask 64x64 store (fixed seeds) is queried through both
packages — SQL → LogicalPlan → engine run, on the host backend and on the
device backend (here a CPU device, so kernels run their plain versions).
Ids, scores and ExecStats accounting must be identical, and the naive
scan must agree.  Scores are float64 from the same int32 counts, so
equality is exact.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.core import CHIConfig as JCfg
from repro.core import MaskStore as JStore
from repro.core import queries as jq
from repro.core.backend import get_backend as jget_backend
from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from repro_torch.core import CHIConfig as TCfg
from repro_torch.core import MaskStore as TStore
from repro_torch.core import queries as tq
from repro_torch.core.backend import get_backend, host_backend
from repro_torch.core.exprs import CP, MaskEvalContext

N, H, W = 64, 64, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FILTER_SQL = ("SELECT mask_id FROM MasksDatabaseView "
              "WHERE CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.02;")
SLICE = {"quickstart_filter": FILTER_SQL,
         "scenario1_topk": jq.SCENARIO1_TOPK,
         "scenario2_topk": jq.SCENARIO2_TOPK,
         "scenario3_iou": jq.SCENARIO3_IOU}
MORE = [
    "SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, roi, (0.8, 1.0)) "
    "> 50 AND NOT CP(mask, full_img, (0.2, 0.6)) < 100 ORDER BY "
    "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 10;",
    "SELECT mask_id FROM MasksDatabaseView WHERE mask_type IN (1) AND "
    "(CP(mask, full_img, (0.5, 1.0)) < 300 OR CP(mask, roi, (0.9, inf)) "
    "> 20);",
    "SELECT mask_id FROM MasksDatabaseView WHERE CP(mask, (8, 8, 40, 56), "
    "(0.25, 0.75)) >= 700;",
    "SELECT SCALAR_AGG(SUM, CP(mask, roi, (0.5, 1.0))) FROM "
    "MasksDatabaseView;",
    "SELECT SCALAR_AGG(AVG, CP(mask, full_img, (0.9, 1.0))) FROM "
    "MasksDatabaseView WHERE mask_type IN (2);",
    "SELECT SCALAR_AGG(MIN, CP(mask, roi, (0.3, 0.7)) / AREA(roi)) FROM "
    "MasksDatabaseView;",
    "SELECT SCALAR_AGG(MAX, CP(mask, full_img, (0.6, 1.0))) FROM "
    "MasksDatabaseView;",
    "SELECT image_id, CP(union(mask > 0.5), full_img, (0.5, 2.0)) AS u "
    "FROM MasksDatabaseView WHERE mask_type IN (1, 2) GROUP BY image_id "
    "ORDER BY u DESC LIMIT 7;",
    "SELECT mask_id FROM MasksDatabaseView ORDER BY -CP(mask, roi, "
    "(0.1, 0.4)) + 2 * CP(mask, full_img, (0.7, 1.0)) ASC LIMIT 9;",
]
STATS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds",
         "n_dropped_masks", "bytes_loaded", "bytes_saved", "chi_bytes")


@pytest.fixture(scope="module")
def db():
    rois = object_boxes(N, H, W, seed=1)
    masks, _ = saliency_masks(N, H, W, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    meta = np.zeros(N, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(N)
    meta["image_id"] = np.arange(N) // 2
    meta["mask_type"] = np.arange(N) % 2 + 1
    cfg = dict(grid=16, num_bins=16, height=H, width=W)
    # create on the first half, append the rest: the incremental-ingest
    # path, as the chip smoke drives it
    j = JStore.create_memory(masks[:32], meta[:32], JCfg(**cfg))
    j.append(masks[32:], meta[32:])
    t = TStore.create_memory(masks[:32], meta[:32], TCfg(**cfg), device="cpu")
    t.append(masks[32:], meta[32:])
    return j, t, rois[meta["mask_id"]]


def _assert_same(got, want, label):
    (tres, tst), (jres, jst) = got, want
    if isinstance(jres, tuple):
        np.testing.assert_array_equal(tres[0], jres[0], err_msg=label)
        np.testing.assert_array_equal(tres[1], jres[1], err_msg=label)
    elif isinstance(jres, float):
        assert (np.isnan(jres) and np.isnan(tres)) or tres == jres, label
    else:
        np.testing.assert_array_equal(tres, jres, err_msg=label)
    for f in STATS:
        assert getattr(tst, f) == getattr(jst, f), (label, f)


@pytest.mark.parametrize("backend", ["host", "device", "mesh"])
@pytest.mark.parametrize("name", list(SLICE))
def test_slice_queries_match_jax(db, name, backend):
    j, t, rois = db
    sql = SLICE[name]
    want = jq.run(sql, j, provided_rois=rois, backend=backend)
    got = tq.run(sql, t, provided_rois=rois, backend=backend)
    _assert_same(got, want, f"{name}/{backend}")


@pytest.mark.parametrize("name", list(SLICE))
def test_naive_scan_matches_indexed_and_jax(db, name):
    j, t, rois = db
    sql = SLICE[name]
    scan = tq.run(sql, t, provided_rois=rois, use_index=False)
    _assert_same(scan, jq.run(sql, j, provided_rois=rois, use_index=False),
                 f"{name}/scan")
    indexed, _ = tq.run(sql, t, provided_rois=rois, backend="device")
    res = scan[0]
    if isinstance(res, tuple):
        np.testing.assert_array_equal(indexed[0], res[0])
        np.testing.assert_array_equal(indexed[1], res[1])
    else:
        np.testing.assert_array_equal(indexed, res)


@pytest.mark.parametrize("backend", ["host", "device", "mesh"])
@pytest.mark.parametrize("i", range(len(MORE)))
def test_plan_kinds_match_jax(db, i, backend):
    """Filtered top-k, boolean predicates, constant ROIs, scalar
    aggregates, grouped rankings and arithmetic over CP terms."""
    j, t, rois = db
    want = jq.run(MORE[i], j, provided_rois=rois, backend=backend,
                  verify_batch=7)
    got = tq.run(MORE[i], t, provided_rois=rois, backend=backend,
                 verify_batch=7)
    _assert_same(got, want, f"{i}/{backend}")


def test_results_survive_mutation_like_jax():
    """Append, update and delete between queries: the device backend's
    resident copies follow the store's epochs as the JAX backend's do."""
    rois = object_boxes(24, 32, 32, seed=5)
    masks, _ = saliency_masks(24, 32, 32, seed=4, attacked_fraction=0.25,
                              boxes=rois)
    meta = np.zeros(24, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(24)
    meta["image_id"] = np.arange(24) // 2
    meta["mask_type"] = np.arange(24) % 3 + 1
    cfg = dict(grid=4, num_bins=8, height=32, width=32)
    j = JStore.create_memory(masks[:16], meta[:16], JCfg(**cfg))
    t = TStore.create_memory(masks[:16], meta[:16], TCfg(**cfg), device="cpu")
    sql = SLICE["scenario2_topk"].replace("25", "6")
    steps = [lambda s: s.append(masks[16:], meta[16:]),
             lambda s: s.update([3, 17], masks[[5, 6]] * 0.9),
             lambda s: s.delete([0, 9, 20])]
    for step in [None] + steps:
        if step is not None:
            step(j)
            step(t)
        for backend in ("host", "device"):
            want = jq.run(sql, j, backend=backend)
            got = tq.run(sql, t, backend=backend)
            _assert_same(got, want, f"epoch {t.epoch}/{backend}")


@pytest.mark.parametrize("share_loads", [True, False])
def test_workload_shares_loads_like_jax(db, share_loads):
    """A multi-query workload: the shared-load cache pays each mask's
    bytes once, with the JAX package's exact I/O accounting."""
    from repro.core.multiquery import run_workload as jrun
    from repro_torch.core.multiquery import run_workload as trun
    j, t, rois = db
    sqls = ["SELECT mask_id FROM MasksDatabaseView ORDER BY "
            f"CP(mask, full_img, ({lv}, {lv + 0.3})) DESC LIMIT 10;"
            for lv in (0.2, 0.25, 0.3)] + [SLICE["quickstart_filter"]]
    jres, jws = jrun(j, sqls, provided_rois=rois, share_loads=share_loads)
    tres, tws = trun(t, sqls, provided_rois=rois, share_loads=share_loads)
    for a, b in zip(tres, jres):
        if isinstance(b, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        else:
            np.testing.assert_array_equal(a, b)
    assert (tws.files_loaded, tws.bytes_loaded, tws.total_verified) == \
        (jws.files_loaded, jws.bytes_loaded, jws.total_verified)
    assert not t.cache_enabled


def test_verify_counts_identical_across_backends(db):
    _, t, rois = db
    ctx = MaskEvalContext(t, np.arange(N), rois)
    batch = np.array([0, 5, 9, 33, 63])
    terms = [CP("provided", 0.8, 1.0), CP(None, 0.2, 0.6),
             CP((4, 4, 60, 30), 0.0, float("inf"))]
    want = host_backend().verify_counts(ctx, batch, terms)
    got = get_backend(t, "device").verify_counts(
        MaskEvalContext(t, np.arange(N), rois), batch, terms)
    for term in terms:
        np.testing.assert_array_equal(got[term], want[term])


@pytest.mark.parametrize("i", [0, 1, 8])
def test_device_verification_reads_rows_in_place_with_jax_stats(
        db, i, monkeypatch):
    """The device backend hands cp_count_multi the resident (N, H, W)
    array and each round's positions (no gather); ids, scores and
    ExecStats stay the JAX package's."""
    from repro_torch.kernels import ops as kops
    j, t, rois = db
    calls = []
    real = kops.cp_count_multi.plain

    def spy(masks, rois_q, lvs, uvs, positions=None):
        calls.append((tuple(masks.shape), positions is not None,
                      tuple(rois_q.shape)))
        return real(masks, rois_q, lvs, uvs, positions)

    monkeypatch.setattr(kops.cp_count_multi, "plain", spy)
    want = jq.run(MORE[i], j, provided_rois=rois, backend="device",
                  verify_batch=5)
    got = tq.run(MORE[i], t, provided_rois=rois, backend="device",
                 verify_batch=5)
    _assert_same(got, want, f"{i}/device")
    assert calls and got[1].n_rounds == len(calls)
    for shape, indexed, (_, b, _) in calls:
        assert shape == (N, H, W) and indexed and 1 <= b <= 5


def test_fused_counts_identical_across_backends_and_jax(db):
    """The scheduler's cross-query cp_count_multi pass, on both backends."""
    j, t, rois = db
    pos = np.array([1, 2, 8, 40, 41, 63])
    specs = [(rois[pos], 0.8, 1.0),
             (np.tile([0, 0, H, W], (len(pos), 1)), 0.2, 0.6),
             (np.tile([3, 9, 50, 30], (len(pos), 1)), 0.5, float("inf"))]
    want = jget_backend(j, "host").fused_counts(j, pos, specs)
    for name in ("host", "device", "mesh"):
        got = get_backend(t, name).fused_counts(t, pos, specs)
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("desc", [True, False])
def test_topk_frontier_exact_under_f32_collisions(db, desc):
    """Scores closer than one float32 ulp collapse in the device top-k
    (torch.topk picks within a tie differently from lax.top_k); τ is
    resolved at float64, so the frontier equals the host's and the JAX
    device backend's."""
    j, t, _ = db
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
            got = get_backend(t, "device").topk_candidates(
                lb, ub, k, desc, definite, possible)
            np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
            np.testing.assert_array_equal(
                got, jget_backend(j, "device").topk_candidates(
                    lb, ub, k, desc, definite, possible))


@pytest.mark.parametrize("sql", list(SLICE.values()) + MORE + [
    jq.SCENARIO6_DISCREPANCY,
    "EXPLAIN ANALYZE " + jq.SCENARIO2_TOPK])
def test_parser_builds_the_same_plans(sql):
    jp, tp = jq.parse(sql), tq.parse(sql)
    assert tp.plan.signature() == jp.plan.signature()
    assert tp.explain == jp.explain and tp.kind == jp.kind


@pytest.mark.parametrize("stat", ["inter", "union", "diff"])
def test_host_pair_bounds_match_jax(db, stat):
    """The pair operator's host bounds (numpy cell combine over both
    roles' CHI rows) equal the JAX package's."""
    from repro.core.exprs import PairEvalContext as JPair
    from repro.core.exprs import PairTerm as JTerm
    from repro_torch.core.exprs import PairEvalContext as TPair
    from repro_torch.core.exprs import PairTerm as TTerm
    j, t, rois = db
    pos_a, pos_b = np.arange(0, N, 2), np.arange(1, N, 2)
    images = np.arange(N // 2)
    for roi in (None, "provided", (4, 8, 50, 61)):
        for ta, tb in ((0.5, 0.5), (0.25, 0.8125)):
            jb = JPair(j, pos_a, pos_b, images, (1, 2), rois).bounds(
                JTerm(stat, 1, 2, ta, tb, roi))
            tb_ = TPair(t, pos_a, pos_b, images, (1, 2), rois).bounds(
                TTerm(stat, 1, 2, ta, tb, roi))
            np.testing.assert_array_equal(tb_[0], jb[0])
            np.testing.assert_array_equal(tb_[1], jb[1])


@pytest.mark.parametrize("backend", ["host", "device", "mesh"])
def test_scenario6_pair_query_matches_jax(db, backend):
    """The saliency-vs-attention discrepancy ranking runs end to end (the
    store's masks alternate type 1 and 2 per image)."""
    j, t, rois = db
    got, gst = tq.run(jq.SCENARIO6_DISCREPANCY, t, provided_rois=rois,
                      backend=backend)
    want, wst = jq.run(jq.SCENARIO6_DISCREPANCY, j, provided_rois=rois,
                       backend=backend)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for f in STATS:
        assert getattr(gst, f) == getattr(wst, f), f


def _untimed(x):
    """An EXPLAIN report without its timings (wall-clock readings) and
    query ids (the process-wide tracer's counter)."""
    if isinstance(x, dict):
        return {k: "<qid>" if k == "query_id" else _untimed(v)
                for k, v in x.items()
                if k not in ("dur_s", "time_s", "ts", "dur")
                and not k.endswith("_time_s")}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    if isinstance(x, str):
        return re.sub(r"(\w*time_s)=[^\s\]]+", r"\1=<t>", x)
    return x


@pytest.mark.parametrize("backend", ["host", "device", "mesh"])
def test_explain_matches_jax(db, backend):
    """``EXPLAIN`` (the plan tree, not executed) and ``EXPLAIN ANALYZE``
    (the annotated tree, its stats, text and trace) of the same SQL give
    the JAX package's reports, timings removed."""
    j, t, rois = db
    for sql in (jq.SCENARIO2_TOPK, jq.SCENARIO3_IOU, MORE[0]):
        for prefix in ("EXPLAIN ", "EXPLAIN ANALYZE "):
            want = jq.run(prefix + sql, j, provided_rois=rois,
                          backend=backend, verify_batch=7)
            got = tq.run(prefix + sql, t, provided_rois=rois,
                         backend=backend, verify_batch=7)
            assert got["analyzed"] == (prefix == "EXPLAIN ANALYZE ")
            assert _untimed(got) == _untimed(want), prefix + sql


@pytest.mark.parametrize("packed", [False, True])
def test_multi_round_mask_agg_loads_like_jax(packed, monkeypatch):
    """``SCENARIO3_IOU`` on the host backend in 16 rounds of 4 groups: ids,
    scores and ``ExecStats`` (bytes loaded among them) equal the JAX
    package's, and every row ``MaskEvalContext.masks_for`` returns equals
    ``store.load`` of its position."""
    n, h, w = 128, 32, 32
    rois = object_boxes(n, h, w, seed=3)
    masks, _ = saliency_masks(n, h, w, seed=2, attacked_fraction=0.2,
                              boxes=rois)
    if packed:
        masks = (masks > 0.5).astype(np.float32)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = dict(grid=8, num_bins=8, height=h, width=w)
    j = JStore.create_memory(masks, meta, JCfg(**cfg), packed=packed)
    t = TStore.create_memory(masks, meta, TCfg(**cfg), packed=packed,
                             device="cpu")
    calls = []
    masks_for = MaskEvalContext.masks_for

    def spy(ctx, idx):
        rows = masks_for(ctx, idx)
        calls.append((ctx, np.array(idx), rows.copy()))
        return rows
    monkeypatch.setattr(MaskEvalContext, "masks_for", spy)
    want = jq.run(jq.SCENARIO3_IOU, j, provided_rois=rois, backend="host",
                  verify_batch=4)
    got = tq.run(jq.SCENARIO3_IOU, t, provided_rois=rois, backend="host",
                 verify_batch=4)
    _assert_same(got, want, f"packed={packed}")
    # two MASK_AGG terms (intersection and union) read each round's rows
    assert got[1].n_rounds >= 8 and len(calls) == 2 * got[1].n_rounds
    for ctx, idx, rows in calls:
        np.testing.assert_array_equal(rows, t.load(ctx.positions[idx]))


def test_port_imports_no_jax_and_no_reference_package():
    code = ("import sys; import repro_torch, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.data.masks; "
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
