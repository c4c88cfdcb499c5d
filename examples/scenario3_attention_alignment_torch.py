"""Scenario 3 (paper §4) on the PyTorch port: model saliency vs human
attention discrepancies.

The same workflow as ``examples/scenario3_attention_alignment.py``, on
``repro_torch`` and ``--device`` (default ``cuda``), on the host backend
(the original's default).  For each of Bob's images the store holds TWO
masks (mask_type 1 = model saliency, mask_type 2 = human attention).  The
paper's aggregation query thresholds both, groups by image, and ranks by
IoU ascending — images where the model looks *away* from where humans look.

We plant a fraction of "misaligned" images (human attention displaced from
the model blob) and check the query surfaces them.

    PYTHONPATH=src python examples/scenario3_attention_alignment_torch.py \
        [--device cuda]
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

    n_images, h, w = 600, 128, 128
    rng = np.random.default_rng(3)
    boxes = object_boxes(n_images, h, w, seed=4)
    # model saliency: mostly in-box
    model_masks, _ = saliency_masks(n_images, h, w, seed=5, boxes=boxes,
                                    in_box_fraction=1.0)
    # human attention: the same region the model looks at, with human-ish
    # jitter — EXCEPT for planted misaligned images (random off-object gaze)
    misaligned = rng.random(n_images) < 0.08
    jitter, _ = saliency_masks(n_images, h, w, seed=6, boxes=boxes,
                               in_box_fraction=1.0)
    human_aligned = np.clip(0.9 * model_masks + 0.25 * jitter, 0.0,
                            1.0 - 1e-6)
    human_off, _ = saliency_masks(n_images, h, w, seed=7, boxes=None)
    human_masks = np.where(misaligned[:, None, None], human_off,
                           human_aligned)

    masks = np.stack([model_masks, human_masks], axis=1).reshape(-1, h, w)
    n = len(masks)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    cfg = CHIConfig(grid=16, num_bins=20, height=h, width=w)
    store = MaskStore.create_memory(masks, meta, cfg, device=args.device)
    print(f"{n_images} images × 2 mask types; "
          f"{int(misaligned.sum())} planted misalignments")

    (img_ids, ious), stats = queries.run(queries.SCENARIO3_IOU, store,
                                         backend="host")
    hits = misaligned[img_ids].mean()
    print(f"\n{queries.SCENARIO3_IOU}")
    print(f"25 lowest-IoU images: precision={hits:.0%} "
          f"(IoU range {ious[0]:.3f}..{ious[-1]:.3f})")
    print(f"groups verified: {stats.n_verified}/{stats.n_candidates}")

    # sanity: aligned images have much higher IoU
    (top_ids, top_ious), _ = queries.run(
        "SELECT image_id, CP(intersect(mask > 0.8), full_img, (0.5, 2.0)) "
        "/ CP(union(mask > 0.8), full_img, (0.5, 2.0)) AS iou "
        "FROM MasksDatabaseView WHERE mask_type IN (1, 2) "
        "GROUP BY image_id ORDER BY iou DESC LIMIT 5;", store,
        backend="host")
    print(f"best-aligned IoUs: {np.round(top_ious, 3)}")


if __name__ == "__main__":
    main()
