"""Scenario 5 on the PyTorch port: model iteration — the database changes
*between* queries.

The same loop as ``examples/scenario5_model_iteration.py``, on
``repro_torch`` and ``--device`` (default ``cuda``).

The paper's motivating workflows are iterative: a model is retrained, its
saliency maps are regenerated, and the analyst re-runs the same queries to
see what moved.  This scenario drives that loop against the mutable,
epoch-versioned store:

1. ingest model v1's saliency masks and run the debugging queries
   (top-k "most saliency outside the object box" + a filter);
2. "retrain" — regenerate the masks for a subset of images (v2 is less
   attacked) and **re-ingest them under the same mask_ids**
   (``on_conflict="update"``: bytes + CHI rows replaced incrementally,
   the store epoch advances, every pre-epoch cache entry becomes
   unreachable);
3. re-run the same queries and diff the top-k — which suspects the
   retrain cleared, which remain;
4. append a fresh batch of masks for images the new model saw for the
   first time, and show the incremental chunked index absorbing it.

    PYTHONPATH=src python examples/scenario5_model_iteration_torch.py
    PYTHONPATH=src python examples/scenario5_model_iteration_torch.py \
        --backend device [--device cuda] [--n-masks 16384 --size 224]
"""

import argparse

import numpy as np

from repro_torch.core import CHIConfig, MaskStore
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.data.masks import object_boxes, saliency_masks
from repro_torch.service import MaskSearchService

TOPK = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
        "CP(mask, full_img, (0.5, 1.0)) DESC LIMIT 15;")
FILTER = ("SELECT mask_id FROM MasksDatabaseView WHERE "
          "CP(mask, full_img, (0.5, 1.0)) > 1500;")


def build_v1(n, size, device):
    rois = object_boxes(n, size, size, seed=11)
    masks, attacked = saliency_masks(n, size, size, seed=10,
                                     attacked_fraction=0.3, boxes=rois,
                                     in_box_fraction=0.6)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n)
    meta["model_id"] = 1
    meta["mask_type"] = 1
    cfg = CHIConfig(grid=16, num_bins=16, height=size, width=size)
    return (MaskStore.create_memory(masks, meta, cfg, device=device), rois,
            attacked)


def retrain_v2(n, size, rois):
    """The retrained model: saliency concentrates back inside the boxes."""
    masks, _ = saliency_masks(n, size, size, seed=20, attacked_fraction=0.05,
                              boxes=rois, in_box_fraction=0.95)
    return masks


def diff_topk(before, after):
    b, a = list(before), list(after)
    stayed = [m for m in a if m in b]
    entered = [m for m in a if m not in b]
    cleared = [m for m in b if m not in a]
    return stayed, entered, cleared


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-masks", type=int, default=400)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--backend", default="host",
                    choices=("host", "device", "mesh"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    store, rois, attacked = build_v1(args.n_masks, args.size, args.device)
    svc = MaskSearchService(store, provided_rois=rois, backend=args.backend)
    print(f"== model iteration on backend {svc.backend.name} ==\n")

    # -- round 1: model v1 -------------------------------------------------
    out1 = svc.query(TOPK)
    flt1 = svc.query(FILTER)
    print(f"[v1 / epoch {svc.stats()['epoch']}] "
          f"top-15 high-saliency suspects: {out1['ids'][:8]}…")
    print(f"[v1] filter matches: {len(flt1['ids'])} masks "
          f"(verified {out1['stats']['n_verified']}"
          f"/{out1['stats']['n_candidates']} for the ranking)\n")

    # -- retrain: regenerate masks for the flagged images and re-ingest ----
    suspects = np.asarray(out1["ids"], np.int64)
    v2 = retrain_v2(args.n_masks, args.size, rois)
    r = svc.ingest(v2[suspects], mask_ids=suspects, model_ids=2,
                   on_conflict="update")
    print(f"[retrain] re-ingested {r['updated']} masks for model v2 → "
          f"epoch {r['epoch']} (CHI rows patched incrementally, "
          f"{len(store.chi_chunks)} chunk(s))")

    # -- round 2: same queries, new epoch ----------------------------------
    out2 = svc.query(TOPK)
    flt2 = svc.query(FILTER)
    assert not out2["cache_hit"], "pre-epoch cache entry must not be served"
    stayed, entered, cleared = diff_topk(out1["ids"], out2["ids"])
    print(f"\n[v2 / epoch {svc.stats()['epoch']}] top-15 diff vs v1:")
    print(f"  cleared by retrain : {len(cleared):3d}  {cleared[:6]}…")
    print(f"  still suspicious   : {len(stayed):3d}  {stayed[:6]}…")
    print(f"  new entrants       : {len(entered):3d}  {entered[:6]}…")
    print(f"  filter matches     : {len(flt1['ids'])} → {len(flt2['ids'])}")

    # -- new images: append rides in as one new CHI chunk ------------------
    n_new = 50
    fresh_rois = object_boxes(n_new, args.size, args.size, seed=31)
    fresh, _ = saliency_masks(n_new, args.size, args.size, seed=30,
                              attacked_fraction=0.05, boxes=fresh_rois,
                              in_box_fraction=0.95)
    r = svc.ingest(fresh, image_ids=args.n_masks + np.arange(n_new),
                   model_ids=2)
    print(f"\n[append] {r['appended']} masks for unseen images → "
          f"epoch {r['epoch']}, {r['n_masks']} total, "
          f"{len(store.chi_chunks)} CHI chunk(s) — no existing row re-indexed")
    out3 = svc.query(TOPK)
    st = svc.stats()
    print(f"[v2+new] top-15 now: {out3['ids'][:8]}…")
    print(f"\nservice stats: epoch={st['epoch']} n_masks={st['n_masks']} "
          f"result_cache={st['result_cache']['hits']}h/"
          f"{st['result_cache']['misses']}m "
          f"bounds_cache={st['bounds_cache']['hits']}h/"
          f"{st['bounds_cache']['misses']}m")
    svc.close()


if __name__ == "__main__":
    main()
