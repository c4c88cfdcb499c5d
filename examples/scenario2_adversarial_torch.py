"""Scenario 2 (paper §4) on the PyTorch port: identifying adversarial
attacks via saliency dispersion.

The same workflow as ``examples/scenario2_adversarial.py``, on
``repro_torch`` and ``--device`` (default ``cuda``), on the host backend
(the original's default).  Claudia's production image classifier starts
misbehaving; the saliency maps of attacked inputs show *diffused*
attention.  The store holds saliency masks for a mixed clean/attacked
population; the paper's query

    SELECT mask_id FROM MasksDatabaseView
    ORDER BY CP(mask, full_img, (0.2, 0.6)) DESC LIMIT 25;

retrieves the most-dispersed masks.  We report precision/recall against the
planted ground truth and the I/O the index saved.

    PYTHONPATH=src python examples/scenario2_adversarial_torch.py [--device cuda]
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

    n, h, w = 2000, 128, 128
    boxes = object_boxes(n, h, w, seed=11)
    masks, attacked = saliency_masks(n, h, w, seed=10,
                                     attacked_fraction=0.03, boxes=boxes)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n)
    cfg = CHIConfig(grid=16, num_bins=20, height=h, width=w)
    store = MaskStore.create_memory(masks, meta, cfg, device=args.device)
    n_attacked = int(attacked.sum())
    print(f"population: {n} masks, {n_attacked} attacked (unknown to the DB)")

    k = 25
    (ids, scores), stats = queries.run(queries.SCENARIO2_TOPK, store,
                                       backend="host")
    hits = attacked[store.positions_of(ids)]
    print(f"\n{queries.SCENARIO2_TOPK}")
    print(f"top-{k} dispersion: precision={hits.mean():.0%}, "
          f"recall={hits.sum() / max(n_attacked, 1):.0%}")
    print(f"index decided {stats.n_decided_by_bounds}/{stats.n_candidates}; "
          f"loaded {stats.load_fraction:.1%} of mask bytes "
          f"in {stats.n_rounds} verification rounds")

    # interactive flow: the attendee tightens the range after looking at the
    # returned masks (demo's custom upper/lower bounds)
    sql = ("SELECT mask_id FROM MasksDatabaseView "
           "ORDER BY CP(mask, full_img, (0.25, 0.5)) DESC LIMIT 25;")
    (ids2, _), stats2 = queries.run(sql, store, backend="host")
    hits2 = attacked[store.positions_of(ids2)]
    print(f"\nrefined range (0.25, 0.5): precision={hits2.mean():.0%}, "
          f"loaded {stats2.load_fraction:.1%}")


if __name__ == "__main__":
    main()
