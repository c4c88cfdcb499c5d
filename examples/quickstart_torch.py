"""Quickstart on the PyTorch port: build a mask DB, index it, run the
paper's three query types.

The same walk as ``examples/quickstart.py``, on ``repro_torch`` and
``--device`` (default ``cuda``).  The queries run on the host backend, the
original's default (the port's own default on a card store is the device
backend, which loads no mask bytes and would change the printed I/O).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
"""

import argparse

import numpy as np

from repro_torch.core import CHIConfig, MaskStore, queries
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.data.masks import object_boxes, saliency_masks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 1. a small mask database: 2 mask types (saliency + human attention)
    #    per image, with per-image object boxes
    n, h, w = 400, 128, 128
    rois = object_boxes(n, h, w, seed=1)
    masks, attacked = saliency_masks(n, h, w, seed=0, attacked_fraction=0.15,
                                     boxes=rois)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1

    # 2. index it (CHI) — in-memory tier for the quickstart
    cfg = CHIConfig(grid=16, num_bins=16, height=h, width=w)
    store = MaskStore.create_memory(masks, meta, cfg, device=args.device)
    print(f"DB: {n} masks {h}x{w}; CHI is "
          f"{cfg.index_bytes(n) / cfg.mask_bytes(n):.1%} of the mask bytes")

    # 3. Filter query (paper §2)
    sql = ("SELECT mask_id FROM MasksDatabaseView "
           "WHERE CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.02;")
    ids, stats = queries.run(sql, store, provided_rois=rois[meta["mask_id"]],
                             backend="host")
    print(f"\nFILTER  {sql}\n  -> {len(ids)} masks; "
          f"verified {stats.n_verified}/{stats.n_candidates} "
          f"({stats.load_fraction:.1%} of mask bytes loaded)")

    # 4. Top-K query (Scenario 2: most diffused attention)
    (ids, scores), stats = queries.run(queries.SCENARIO2_TOPK, store,
                                       backend="host")
    hits = attacked[store.positions_of(ids)].sum()
    print(f"\nTOPK    {queries.SCENARIO2_TOPK}\n  -> top-25 dispersion; "
          f"{hits} of 25 are the planted 'attacked' masks; "
          f"verified {stats.n_verified}/{stats.n_candidates}")

    # 5. Aggregation query (Scenario 3: model-vs-human attention IoU)
    (img_ids, ious), stats = queries.run(queries.SCENARIO3_IOU, store,
                                         backend="host")
    print(f"\nAGG     {queries.SCENARIO3_IOU}\n  -> 25 lowest-IoU images; "
          f"worst IoU={ious[0]:.3f}; verified {stats.n_verified} groups")


if __name__ == "__main__":
    main()
