"""Scenario 1 (paper §4) on the PyTorch port: the full debug → query →
augment → retrain loop, as an end-to-end training driver.

The same loop as ``examples/scenario1_debugging.py``, on ``repro_torch``
and ``--device`` (default ``cuda``).  A small LM ("the classifier") is
trained with a planted spurious correlation: for half the examples a
background token pattern predicts the labels, so the model learns to
attend outside the "object span".  We then:

  1. harvest attention masks into a MaskSearch store (token-grid masks),
  2. run the paper's Top-K query — lowest normalized attention inside the
     object-span ROI — to retrieve the spurious examples,
  3. augment: re-randomize the background (outside-ROI) tokens of the
     retrieved examples (labels unchanged),
  4. retrain on the augmented stream and re-measure the query:
     attention-inside-ROI should rise.

    PYTHONPATH=src python examples/scenario1_debugging_torch.py \
        [--steps 120] [--device cuda]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import load_smoke
from repro_torch.core import CHIConfig, MaskStore, queries, saliency
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import init_train_state, make_train_step

SEQ = 64
OBJ = (16, 48)          # the "object" span: tokens 16..48
GRID = 8                # token-grid mask: 8x8


def make_batch(rng, cfg, batch, spurious_frac=0.5):
    """Sequences whose labels are predictable from the object span — but a
    background shortcut (tokens outside OBJ) leaks the same signal for a
    fraction of examples."""
    tokens = rng.integers(0, cfg.vocab_size, (batch, SEQ), dtype=np.int64)
    signal = rng.integers(0, 8, batch)
    # object span carries the signal
    tokens[:, OBJ[0]:OBJ[0] + 8] = signal[:, None] * 8 + np.arange(8)
    # the shortcut: background repeats the signal for `spurious_frac`
    leak = rng.random(batch) < spurious_frac
    tokens[leak, :8] = (signal[leak, None] * 8 + np.arange(8))
    labels = np.full((batch, SEQ), -1, np.int64)
    labels[:, -1] = signal  # predict the signal at the last position
    return {"tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32)}, leak


def harvest_masks(model, batch):
    maps = model.attention_maps(batch)                # (B, heads, S, S)
    # per-example mask: where does the *last* position attend?
    att = maps.mean(dim=1)[:, -1, :]                  # (B, S)
    return saliency.tokens_to_grid(saliency.normalize01(att, axis=(-1,)),
                                   GRID, GRID).float().cpu().numpy()


def attention_in_roi(masks):
    span = np.zeros(SEQ, bool)
    span[OBJ[0]:OBJ[1]] = True
    grid_mask = span.reshape(GRID, GRID)
    return (masks * grid_mask[None]).sum((1, 2)) / masks.sum((1, 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = load_smoke("granite_3_2b")
    opt_cfg = OptConfig(learning_rate=1e-3, warmup_steps=10,
                        total_steps=2 * args.steps)
    model, opt = init_train_state(build_model(cfg, dev),
                                  torch.Generator(dev).manual_seed(0),
                                  opt_cfg)
    step = make_train_step(model, opt_cfg)
    rng = np.random.default_rng(0)

    # -- phase 1: train with the spurious shortcut ------------------------
    for s in range(args.steps):
        batch, _ = make_batch(rng, cfg, args.batch)
        opt, metrics = step(opt, batch)
    print(f"phase-1 loss: {float(metrics['loss']):.3f}")

    # -- harvest masks + index ---------------------------------------------
    probe, leak = make_batch(rng, cfg, args.batch)
    masks = harvest_masks(model, probe)
    n = len(masks)
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n)
    chi_cfg = CHIConfig(grid=GRID, num_bins=8, height=GRID, width=GRID)
    store = MaskStore.create_memory(masks, meta, chi_cfg, device=dev)

    # ROI = the object span, as grid rows
    roi = np.array([OBJ[0] // GRID, 0, OBJ[1] // GRID, GRID], np.int32)
    rois = np.tile(roi, (n, 1))

    # -- the paper's query: least attention inside the object ROI ---------
    k = max(n // 4, 2)
    sql = (f"SELECT mask_id FROM MasksDatabaseView ORDER BY "
           f"CP(mask, roi, (0.5, 1.0)) / AREA(roi) ASC LIMIT {k};")
    (ids, scores), stats = queries.run(sql, store, provided_rois=rois)
    flagged = store.positions_of(ids)
    in_roi_before = attention_in_roi(masks).mean()
    print(f"query flagged {len(ids)} examples "
          f"(verified {stats.n_verified}/{stats.n_candidates}); "
          f"{leak[flagged].mean():.0%} of flagged have the planted shortcut; "
          f"mean attention-in-ROI: {in_roi_before:.3f}")

    # -- augment: randomize the background of flagged examples ------------
    def augment(batch, flagged_rows):
        toks = batch["tokens"].copy()
        back = np.ones(SEQ, bool)
        back[OBJ[0]:OBJ[1]] = False
        r = np.random.default_rng(1)
        for row in flagged_rows:
            toks[row, back] = r.integers(0, cfg.vocab_size, back.sum())
        return dict(batch, tokens=toks)

    # -- phase 2: retrain on augmented stream ------------------------------
    for s in range(args.steps):
        batch, lk = make_batch(rng, cfg, args.batch)
        batch = augment(batch, np.nonzero(lk)[0])  # online augmentation
        opt, metrics = step(opt, batch)
    print(f"phase-2 loss: {float(metrics['loss']):.3f}")

    masks2 = harvest_masks(model, probe)
    in_roi_after = attention_in_roi(masks2).mean()
    print(f"mean attention-in-ROI after augment+retrain: {in_roi_after:.3f} "
          f"(was {in_roi_before:.3f})")
    if in_roi_after > in_roi_before:
        print("=> model now relies more on the object span (Scenario-1 win)")


if __name__ == "__main__":
    main()
