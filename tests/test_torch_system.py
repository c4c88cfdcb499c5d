"""PyTorch port: the full ML-workflow loop against the JAX package's.

The mirror of ``tests/test_system.py`` (Scenario 1, compressed): train a
small model → harvest attention masks into the store → query → augment →
retrain step.  Both packages start from one parameter tree
(``test_torch_models.reference_params``, ``wq``/``wk`` at a quarter of the
init scale) and see the same batches, so the port's loss is held to the
reference's at every step (bf16: ``rtol = atol = 2e-2``, ``atol`` in units
of the loss), and decreases as the reference's must.  The query on the
port's harvested masks must equal the port's naive scan.  Last, the
Scenario 1 example on the port runs end to end at a tiny size.
"""

import importlib.util
import io
import os
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.configs import load_smoke
from repro_torch.core import CHIConfig, MaskStore, augment, queries, saliency
from repro_torch.core.store import MASK_META_DTYPE
from repro_torch.data.pipeline import AugmentedData, SyntheticLMData
from repro_torch.models import build_model
from repro_torch.models.convert import load_reference_params
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step
from test_torch_models import assert_close, reference_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=30)


def test_full_workflow_loop():
    jc = jconfigs.load_smoke("granite_3_2b")
    cfg = load_smoke("granite_3_2b")
    params = reference_params(jc, qk_scale=0.25)
    model = load_reference_params(build_model(cfg, "cpu"),
                                  jax.tree.map(np.asarray, params))
    opt_cfg = OptConfig(**OPT)
    opt = init_opt_state(model.parameters(), opt_cfg)
    step = make_train_step(model, opt_cfg)
    jopt_cfg = jopt.OptConfig(**OPT)
    jstate = jopt.init_opt_state(params, jopt_cfg)
    jstep = jax.jit(jloop.make_train_step(jbuild(jc), jopt_cfg))
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8)

    # 1. train a few steps, beside the reference
    losses = []
    for s in range(8):
        batch = data.batch_at(s)
        opt, metrics = step(opt, batch)
        params, jstate, jmetrics = jstep(params, jstate, batch)
        losses.append(float(metrics["loss"]))
        assert_close(losses[-1], float(jmetrics["loss"]), "bfloat16",
                     f"loss at step {s}")
    assert losses[-1] < losses[0], "training must reduce loss"

    # 2. harvest attention masks into a MaskSearch store
    batch = data.batch_at(100)
    maps = model.attention_maps(batch)                # (B, H, S, S)
    masks = saliency.normalize01(maps.mean(dim=1)).float().numpy()
    n, h, w = masks.shape
    assert np.isfinite(masks).all() and masks.min() >= 0
    meta = np.zeros(n, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n)
    chi_cfg = CHIConfig(grid=8, num_bins=8, height=h, width=w)
    store = MaskStore.create_memory(masks, meta, chi_cfg, device="cpu")

    # 3. query: which examples have the least diagonal-band attention?
    sql = ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
           "CP(mask, full_img, (0.5, 1.0)) ASC LIMIT 4;")
    (ids, scores), stats = queries.run(sql, store)
    assert len(ids) == 4
    assert stats.n_candidates == n
    (scan_ids, scan_scores), _ = queries.run(sql, store, use_index=False)
    np.testing.assert_array_equal(ids, scan_ids)
    np.testing.assert_array_equal(scores, scan_scores)

    # 4. augment the selected rows and take another train step
    sel = torch.as_tensor(np.isin(meta["mask_id"], ids))
    new_tokens = augment.mix_augmented(torch.Generator().manual_seed(7),
                                       torch.as_tensor(batch["tokens"]), sel,
                                       cfg.vocab_size)
    assert torch.equal(new_tokens[~sel],
                       torch.as_tensor(batch["tokens"])[~sel])
    aug = AugmentedData(data)
    aug.add_augmented(dict(batch, tokens=new_tokens.numpy()))
    batch2 = aug.batch_at(8)
    assert np.array_equal(batch2["tokens"][:4], new_tokens.numpy()[:4])
    opt, metrics = step(opt, batch2)
    assert np.isfinite(float(metrics["loss"]))
    assert int(opt.step) == 9


@pytest.fixture
def scenario1():
    path = os.path.join(REPO, "examples", "scenario1_debugging_torch.py")
    spec = importlib.util.spec_from_file_location("scenario1_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scenario1_example_runs_on_the_port(scenario1):
    out = io.StringIO()
    with redirect_stdout(out):
        scenario1.main(["--steps", "4", "--batch", "8", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("phase-1 loss: ")
    assert lines[1].startswith("query flagged 2 examples (verified ")
    assert lines[2].startswith("phase-2 loss: ")
    assert lines[3].startswith("mean attention-in-ROI after augment+retrain")
    for line in (lines[0], lines[2]):
        assert np.isfinite(float(line.split(": ")[1]))
