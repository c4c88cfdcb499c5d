"""Scenario 4 on the PyTorch port: the demo GUI's interactive refine loop,
against the service.

The same session as ``examples/scenario4_interactive_session.py``, on
``repro_torch`` and ``--device`` (default ``cuda``, where the store and
its device-resident tier live).

A user debugging a model iterates: sweep a filter threshold until the
result set looks right (every refinement reuses the cached CHI bounds
pass), then page through a top-k ranking 25 rows at a time (each "next
page" resumes the verification frontier instead of re-running), while a
second analyst's concurrent queries share verification I/O through the
fused scheduler.

``--backend {host,device,mesh}`` replays the same session transcript on
any execution backend (core/backend.py): the host path loads mask bytes
from disk per verification batch; the device path verifies against the
HBM-resident tier (watch the disk column go to zero); the mesh path runs
the sharded steps over every visible device of the store's type.

    PYTHONPATH=src python examples/scenario4_interactive_session_torch.py
    PYTHONPATH=src python examples/scenario4_interactive_session_torch.py \
        --backend device [--device cuda]
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.core import CHIConfig, MaskStore
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.data.masks import object_boxes, saliency_masks
from repro_torch.service import MaskSearchService


def build_db(root, device, n=600, size=128):
    rois = object_boxes(n, size, size, seed=1)
    masks, _ = saliency_masks(n, size, size, seed=0, attacked_fraction=0.15,
                              boxes=rois)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=size, width=size)
    store = MaskStore.create_disk(os.path.join(root, "db"), masks, meta, cfg,
                                  device=device)
    return store, rois


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="host",
                    choices=("host", "device", "mesh"),
                    help="execution backend for the whole session")
    ap.add_argument("--explain", action="store_true",
                    help="print the EXPLAIN ANALYZE operator tree for the "
                         "ranking and a per-page phase-latency line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="masksearch_s4_")
    try:
        store, rois = build_db(tmp, args.device)
        svc = MaskSearchService(store, provided_rois=rois,
                                backend=args.backend)
        print(f"== backend: {svc.backend.name} ==\n")
        mb = 1 / 1e6

        # -- 1. threshold refine loop (filter) --------------------------------
        print("== refine loop: sweeping the Scenario-1 threshold ==")
        for thr in (0.10, 0.06, 0.04, 0.02):
            sql = ("SELECT mask_id FROM MasksDatabaseView WHERE "
                   f"CP(mask, roi, (0.8, 1.0)) / AREA(roi) < {thr};")
            out = svc.query(sql)
            st = out["stats"]
            print(f"  thr={thr:<5} -> {len(out['ids']):>3} masks | verified "
                  f"{st['n_verified']:>3}/{st['n_candidates']} | "
                  f"loaded {st['bytes_loaded'] * mb:6.2f} MB | "
                  f"bounds cache hits={svc.planner.bounds_cache.info.hits}")
        print("  (one CHI pass served the whole sweep)\n")

        # -- 1b. cost-based conjunction: pyramid ladder + reorder -------------
        if args.explain:
            from repro_torch.core import queries
            from repro_torch.obs.explain import explain_analyze
            area = 128 * 128
            conj = ("SELECT mask_id FROM MasksDatabaseView WHERE "
                    f"CP(mask, full_img, (0.25, 1.0)) > {0.01 * area} AND "
                    f"CP(mask, full_img, (0.75, 1.0)) > {0.3 * area};")
            # the host backend, the original's default
            rep = explain_analyze(store, queries.parse(conj).plan,
                                  backend="host")
            filt = next(c for c in rep["tree"]["children"]
                        if c["op"] == "Filter")
            print("== EXPLAIN ANALYZE: conjunctive WHERE through the "
                  "cost-based optimizer ==")
            print(f"  conjunct order: {filt['order']} "
                  f"({'reordered' if filt['reordered'] else 'plan order'}) | "
                  f"tier ladder: {' -> '.join(map(str, filt['tier_grids']))}")
            for leaf in filt["leaves"]:
                print(f"    start_tier={leaf['start_tier']} "
                      f"est_reject={leaf.get('est_reject', 'n/a')} "
                      f"actual={leaf.get('actual_reject', 'n/a')} "
                      f"ladder={leaf.get('ladder', '(skipped)')}")
            print(f"  index bytes touched: "
                  f"{rep['stats']['chi_bytes'] * mb:.2f} MB\n")

        # -- 2. repeated query: warm result cache -----------------------------
        out = svc.query(sql)
        print(f"== repeat last query: cache_hit={out['cache_hit']}, "
              f"bytes_loaded={out['stats']['bytes_loaded']} ==\n")

        # -- 3. paginated top-k session ---------------------------------------
        print("== session: dispersion ranking, 25 rows per page ==")
        topk = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
                "CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 25;")
        if args.explain:
            rep = svc.query("EXPLAIN ANALYZE " + topk)
            print("-- EXPLAIN ANALYZE (first page's worth of work) --")
            for line in rep["text"].splitlines():
                print(f"  {line}")
            print()
        page = svc.query(topk, session=True, page_size=25)
        sid = page["session"]
        prev_bound = prev_verify = 0.0
        for i in range(4):
            t0 = time.perf_counter()
            if i:
                page = svc.next_page(sid)
            wall = time.perf_counter() - t0
            st = page["stats"]
            ids = page["page"]["ids"]
            print(f"  page {i + 1}: rows {page['page']['offset']:>3}-"
                  f"{page['served'] - 1:>3} (first id {ids[0]:>4}) | "
                  f"cumulative verified {st['n_verified']:>3} | "
                  f"loaded {st['bytes_loaded'] * mb:6.2f} MB")
            if args.explain:
                # run stats are cumulative: the delta is this page's work
                db_, dv = (st["bound_time_s"] - prev_bound,
                           st["verify_time_s"] - prev_verify)
                prev_bound, prev_verify = (st["bound_time_s"],
                                           st["verify_time_s"])
                other = max(wall - db_ - dv, 0.0)
                print(f"          phases: bounds {db_ * 1e3:6.1f} ms | "
                      f"verify {dv * 1e3:6.1f} ms | "
                      f"serve+other {other * 1e3:6.1f} ms")
        print("  (each page resumed the frontier — no re-runs)\n")

        # -- 4. a second analyst: fused concurrent queries --------------------
        print("== concurrent workload: fused verification ==")
        sqls = ["SELECT mask_id FROM MasksDatabaseView ORDER BY "
                f"CP(mask, full_img, ({lv}, {lv + 0.4})) DESC LIMIT 25;"
                for lv in (0.15, 0.2, 0.25, 0.3)]
        svc.submit_batch(sqls)
        sch = svc.scheduler.stats
        print(f"  {len(sqls)} queries -> {sch.fused_passes} fused kernel "
              f"passes ({sch.fused_descriptors} CP descriptors over "
              f"{sch.fused_masks} union mask loads)\n")

        # -- 5. the bill ------------------------------------------------------
        stats = svc.stats()
        cache = stats["shared_cache"]
        io = stats["store_io"]
        print("== service stats ==")
        print(f"  queries: {stats['queries']}")
        print(f"  result cache: {stats['result_cache']}")
        print(f"  bounds cache: {stats['bounds_cache']}")
        print(f"  shared-load cache: hit_rate={cache['hit_rate']:.1%}, "
              f"bytes_saved={cache['bytes_saved'] * mb:.2f} MB")
        print(f"  disk: {io['files_read']} files, "
              f"{io['bytes_read'] * mb:.2f} MB read "
              f"(modeled EBS {io['modeled_ebs_time_s']:.2f}s)")
        svc.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
