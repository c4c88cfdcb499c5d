"""Scenario 6 on the PyTorch port: saliency-vs-attention discrepancy as a
first-class operator.

The same queries as ``examples/scenario6_discrepancy.py``, on
``repro_torch`` and ``--device`` (default ``cuda``), on the host backend
(the original's default).

The demo paper's marquee applications — spurious-correlation hunting and
"exploring discrepancies between model saliency and human attention" — are
queries over *pairs* of masks for the same image.  This scenario runs them
through the dual-mask operator (DESIGN.md §9) instead of the MASK_AGG
group path: per image, mask_type 1 (model saliency) pairs with mask_type 2
(human attention), and

  * ``ORDER BY IOU(saliency, attention, t, t) ASC``  surfaces the images
    where the model looks *away* from where humans look;
  * ``WHERE PAIR_DIFF(saliency, attention, t, t) > X`` filters for images
    with a large model-only region (the spurious-correlation signature);

both pruned by cell-decomposed pair bounds from the two roles' CHI rows —
skipping a pair skips the bytes of **two** masks.

    PYTHONPATH=src python examples/scenario6_discrepancy_torch.py [--device cuda]
"""

import argparse

import numpy as np

from repro_torch.core import CHIConfig, MaskStore, queries
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.data.masks import object_boxes, saliency_masks


def build_store(device, n_images=500, h=128, w=128,
                misaligned_fraction=0.08):
    """Per image: a model-saliency mask (type 1) and a human-attention mask
    (type 2); a planted fraction of images has off-object human gaze."""
    rng = np.random.default_rng(3)
    boxes = object_boxes(n_images, h, w, seed=4)
    model, _ = saliency_masks(n_images, h, w, seed=5, boxes=boxes,
                              in_box_fraction=1.0)
    misaligned = rng.random(n_images) < misaligned_fraction
    jitter, _ = saliency_masks(n_images, h, w, seed=6, boxes=boxes,
                               in_box_fraction=1.0)
    human_aligned = np.clip(0.9 * model + 0.25 * jitter, 0.0, 1.0 - 1e-6)
    human_off, _ = saliency_masks(n_images, h, w, seed=7, boxes=None)
    human = np.where(misaligned[:, None, None], human_off, human_aligned)

    masks = np.stack([model, human], axis=1).reshape(-1, h, w)
    n = len(masks)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=16, height=h, width=w)
    return (MaskStore.create_memory(masks, meta, cfg, device=device),
            misaligned)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    store, misaligned = build_store(args.device)
    n_images = len(store) // 2
    print(f"{n_images} images × (saliency, attention); "
          f"{int(misaligned.sum())} planted misalignments")

    (img_ids, ious), stats = queries.run(queries.SCENARIO6_DISCREPANCY,
                                         store, verify_batch=64,
                                         backend="host")
    hits = misaligned[img_ids].mean()
    print(f"\n{queries.SCENARIO6_DISCREPANCY}")
    print(f"25 lowest-IoU images: precision={hits:.0%} "
          f"(IoU range {ious[0]:.3f}..{ious[-1]:.3f})")
    print(f"pairs verified: {stats.n_verified}/{stats.n_candidates} "
          f"(naive decodes every pair)")

    diff_sql = ("SELECT image_id FROM MasksDatabaseView "
                "WHERE PAIR_DIFF(saliency, attention, 0.6, 0.6) > 1000 "
                "ORDER BY PAIR_DIFF(saliency, attention, 0.6, 0.6) "
                "DESC LIMIT 25;")
    (d_ids, d_counts), d_stats = queries.run(diff_sql, store,
                                             verify_batch=64, backend="host")
    print(f"\n{diff_sql}")
    print(f"{len(d_ids)} images where the model attends ≥1000 px the "
          f"humans ignore; planted precision="
          f"{misaligned[d_ids].mean():.0%}" if len(d_ids) else "no hits")
    print(f"pairs verified: {d_stats.n_verified}/{d_stats.n_candidates}, "
          f"decided by pair bounds alone: {d_stats.n_decided_by_bounds}")

    # sanity: aligned images have much higher IoU
    (_, top_ious), _ = queries.run(
        "SELECT image_id FROM MasksDatabaseView "
        "ORDER BY IOU(saliency, attention, 0.6, 0.6) DESC LIMIT 5;",
        store, verify_batch=64, backend="host")
    print(f"\nbest-aligned IoUs: {np.round(top_ious, 3)}")


if __name__ == "__main__":
    main()
