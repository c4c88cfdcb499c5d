"""PyTorch port: stats accounting against the JAX package.

Mirrors ``tests/test_stats_consistency.py`` case by case.  The stats
dataclasses (``ExecStats``, ``IOStats``, ``CacheStats``, ``SchedulerStats``,
``CacheInfo``) must have the JAX package's fields, defaults, ``as_dict``,
``reset`` and ``merge``; the byte attribution of one-shot runs and of the
fused scheduler must equal the JAX package's on the same 30-mask store
(the port's on the CPU), with timing fields removed
(``test_torch_service.plain``).
"""

import dataclasses

import numpy as np
import pytest

from repro.core.store import MASK_META_DTYPE
from repro.data.masks import object_boxes, saliency_masks
from test_torch_service import JAX, TORCH, both, create_memory

B, H, W = 30, 32, 32

STATS_CLASSES = [("engine", "ExecStats"), ("store", "IOStats"),
                 ("store", "CacheStats"), ("scheduler", "SchedulerStats"),
                 ("planner", "CacheInfo")]
IDS = [name for _, name in STATS_CLASSES]


def _cls(P, where):
    return getattr(getattr(P, where[0]), where[1])


@pytest.fixture()
def db():
    """Package name → a fresh store, and the ROIs."""
    rois = object_boxes(B, H, W, seed=7)
    masks, _ = saliency_masks(B, H, W, seed=6, attacked_fraction=0.3,
                              boxes=rois)
    meta = np.zeros(B, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(B)
    meta["image_id"] = np.arange(B) // 2
    meta["mask_type"] = np.arange(B) % 2 + 1
    cfg = dict(grid=4, num_bins=8, height=H, width=W)
    return {P.name: create_memory(P, masks, meta, cfg)
            for P in (JAX, TORCH)}, rois


# -- reflection drift tests --------------------------------------------------


def _poke(obj):
    """Set every numeric field to a distinctive nonzero value."""
    for i, f in enumerate(dataclasses.fields(obj)):
        cur = getattr(obj, f.name)
        if isinstance(cur, bool) or not isinstance(cur, (int, float)):
            continue
        setattr(obj, f.name, type(cur)(i + 7))
    return obj


def _fields(obj) -> list:
    """Every field with its type and default, so a drifted default or a
    field of another type cannot pass."""
    return [(f.name, type(getattr(obj, f.name)).__name__, getattr(obj, f.name))
            for f in dataclasses.fields(obj)]


@pytest.mark.parametrize("where", STATS_CLASSES, ids=IDS)
def test_as_dict_exposes_every_field(where):
    def scenario(P):
        obj = _poke(_cls(P, where)())
        return _fields(_cls(P, where)()), obj.as_dict(), _fields(obj)
    _, d, poked = both(scenario)
    for name, _, value in poked:
        assert name in d and d[name] == value, name


@pytest.mark.parametrize("where", [w for w in STATS_CLASSES
                                   if hasattr(_cls(JAX, w), "reset")],
                         ids=[n for w, n in zip(STATS_CLASSES, IDS)
                              if hasattr(_cls(JAX, w), "reset")])
def test_reset_restores_every_field(where):
    def scenario(P):
        obj = _poke(_cls(P, where)())
        obj.reset()
        return _fields(obj), _fields(_cls(P, where)())
    after, fresh = both(scenario)
    assert after == fresh


def test_iostats_merge_covers_every_field():
    def scenario(P):
        a, b = _poke(P.store.IOStats()), _poke(P.store.IOStats())
        want = {f.name: getattr(a, f.name) + getattr(b, f.name)
                for f in dataclasses.fields(a)}
        a.merge(b)
        return want, {f.name: getattr(a, f.name)
                      for f in dataclasses.fields(a)}
    want, got = both(scenario)
    assert got == want


# -- exact apportionment -----------------------------------------------------


@pytest.mark.parametrize("total,weights", [
    (100, [1, 1, 1]),
    (7, [3, 2, 2]),
    (1, [5, 5]),
    (0, [1, 2]),
    (999983, [17, 3, 250, 1]),
    (10, [0, 0]),
])
def test_apportion_sums_exactly(total, weights):
    shares = both(lambda P: P.scheduler._apportion(total, weights))
    assert len(shares) == len(weights) and all(s >= 0 for s in shares)
    if sum(weights) > 0 and total > 0:
        assert sum(shares) == total
    else:
        assert shares == [0] * len(weights)


# -- byte cross-checks -------------------------------------------------------


def test_one_shot_bytes_match_store_meter(db):
    def scenario(P):
        store = db[0][P.name]
        io0 = store.io.bytes_read
        _, stats = P.plan.run_plan(store, P.queries.parse(
            "SELECT mask_id FROM V ORDER BY CP(mask, roi, (0.8, 1.0)) "
            "ASC LIMIT 10;").plan, provided_rois=db[1], verify_batch=4)
        return stats, store.io.bytes_read - io0
    stats, metered = both(scenario)
    assert stats.bytes_loaded == metered and stats.bytes_saved == 0


def test_scheduler_bytes_partition_store_meter(db):
    sqls = [
        "SELECT mask_id FROM V ORDER BY CP(mask, roi, (0.8, 1.0)) "
        "ASC LIMIT 7;",
        "SELECT mask_id FROM V ORDER BY CP(mask, full_img, (0.2, 0.6)) "
        "DESC LIMIT 9;",
        "SELECT mask_id FROM V WHERE CP(mask, full_img, (0.5, 1.0)) > 10;",
    ]

    def scenario(P):
        store = db[0][P.name]
        runs = [P.plan.compile_plan(store, P.queries.parse(s).plan,
                                    provided_rois=db[1], verify_batch=4)
                for s in sqls]
        for run, s in zip(runs, sqls):
            run.target(P.queries.parse(s).plan.k)
        io0 = store.io.bytes_read
        saved0 = store.cache_stats.bytes_saved
        sched = P.scheduler.FusedScheduler(store)
        sched.drive(runs)
        return ([r.stats for r in runs], [r.result() for r in runs],
                store.io.bytes_read - io0,
                store.cache_stats.bytes_saved - saved0, sched.stats)
    stats, _, metered, saved, sched = both(scenario)
    assert sum(s.bytes_loaded for s in stats) == metered
    assert sum(s.bytes_saved for s in stats) == saved
    assert sched.fused_bytes_loaded <= metered


def test_self_verify_attributes_cache_savings(db):
    def scenario(P):
        store = db[0][P.name]
        plan = P.queries.parse("SELECT mask_id FROM V "
                               "ORDER BY CP(mask, roi, (0.8, 1.0)) ASC "
                               "LIMIT 10;").plan
        owns = store.enable_cache()
        try:
            _, first = P.plan.run_plan(store, plan, provided_rois=db[1],
                                       verify_batch=4)
            io0 = store.io.bytes_read
            _, second = P.plan.run_plan(store, plan, provided_rois=db[1],
                                        verify_batch=4)
            return first, second, store.io.bytes_read - io0, store.cache_stats
        finally:
            if owns:
                store.clear_cache()
    _, second, metered, _ = both(scenario)
    assert second.bytes_loaded == metered == 0
    assert second.bytes_saved > 0


def test_execstats_as_dict_reports_load_fraction():
    d = both(lambda P: P.engine.ExecStats(n_candidates=10,
                                          n_verified=4).as_dict())
    assert d["load_fraction"] == pytest.approx(0.4)
