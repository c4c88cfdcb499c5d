"""PyTorch port: the data pipeline, saliency, augmentation and the
producer → store → query slice vs the JAX package.

Pipeline batches must be bit-identical; saliency functions agree within
1e-5 in float32 on the same numpy inputs; augmentation draws its noise
from a ``torch.Generator`` (not JAX's PRNG), so it is held by property.
The slice: granite SMOKE in float32 with the same weights in both
packages (``test_torch_models.reference_params``) turns one
``SyntheticLMData`` batch into attention masks; each package's store,
fed the same masks, answers Scenario 1's ranking, the same ranking over
the attended pixels and a CP filter with the same ids, scores and
``ExecStats``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import CHIConfig as JCfg
from repro.core import MaskStore as JStore
from repro.core import augment as jaugment
from repro.core import queries as jq
from repro.core import saliency as jsal
from repro.core.store import MASK_META_DTYPE
from repro.data import pipeline as jpipe
from repro.data.masks import object_boxes, saliency_masks
from repro.models import build_model as jbuild
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import CHIConfig as TCfg
from repro_torch.core import MaskStore as TStore
from repro_torch.core import augment as taugment
from repro_torch.core import queries as tq
from repro_torch.core import saliency as tsal
from repro_torch.data import pipeline as tpipe
from repro_torch.models.layers import cross_entropy, logits_from_tied, rms_norm
from test_torch_models import carried, reference_params

STATS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds",
         "n_dropped_masks", "bytes_loaded", "bytes_saved", "chi_bytes")


def close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=atol)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def assert_same_batch(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_pipeline_batches_are_bit_identical(arch):
    """Every config, full and smoke: tokens/labels, the encoder-decoder,
    patches and MTP branches, host sharding and steps."""
    for load in ("load_arch", "load_smoke"):
        jc = getattr(jconfigs, load)(arch)
        tc = getattr(tconfigs, load)(arch)
        for seq, gb, seed, host in ((16, 4, 0, (0, 1)), (9, 6, 3, (1, 2))):
            j = jpipe.SyntheticLMData(jc, seq, gb, seed=seed,
                                      host_index=host[0], host_count=host[1])
            t = tpipe.SyntheticLMData(tc, seq, gb, seed=seed,
                                      host_index=host[0], host_count=host[1])
            for step in (0, 5):
                assert_same_batch(t.batch_at(step), j.batch_at(step))
            it_j, it_t = iter(j), iter(t)
            for _ in range(2):
                assert_same_batch(next(it_t), next(it_j))


def test_prefetch_and_augmented_data_match_the_reference():
    jc, tc = (m.load_smoke("granite_3_2b") for m in (jconfigs, tconfigs))
    src_j = [jpipe.SyntheticLMData(jc, 8, 4).batch_at(i) for i in range(5)]
    src_t = [tpipe.SyntheticLMData(tc, 8, 4).batch_at(i) for i in range(5)]

    def transform(b):
        return {k: v * 2 for k, v in b.items()}
    for depth, fn in ((2, None), (1, transform)):
        got = list(tpipe.PrefetchIterator(iter(src_t), depth=depth,
                                          transform=fn))
        want = list(jpipe.PrefetchIterator(iter(src_j), depth=depth,
                                           transform=fn))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert_same_batch(g, w)
    it = tpipe.PrefetchIterator(iter(tpipe.SyntheticLMData(tc, 8, 4)),
                                depth=2)
    assert_same_batch(next(it), src_t[0])
    it.close()

    aug_j = jpipe.AugmentedData(jpipe.SyntheticLMData(jc, 16, 8, seed=4))
    aug_t = tpipe.AugmentedData(tpipe.SyntheticLMData(tc, 16, 8, seed=4))
    assert_same_batch(aug_t.batch_at(0), aug_j.batch_at(0))
    rng = np.random.default_rng(0)
    for n in (4, 6):
        extra = {"tokens": rng.integers(0, 9, (n, 16)).astype(np.int32),
                 "labels": rng.integers(0, 9, (n, 16)).astype(np.int32)}
        aug_j.add_augmented(extra)
        aug_t.add_augmented(extra)
    for step in range(4):
        assert_same_batch(aug_t.batch_at(step), aug_j.batch_at(step))


# ---------------------------------------------------------------------------
# saliency
# ---------------------------------------------------------------------------


def test_saliency_functions_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 9)).astype(np.float32)
    for axis in ((-2, -1), (-1,)):
        close(tsal.normalize01(torch.from_numpy(x), axis=axis),
              jsal.normalize01(jnp.asarray(x), axis=axis))
    flat = np.zeros((2, 4, 4), np.float32)          # hi == lo
    close(tsal.normalize01(torch.from_numpy(flat)),
          jsal.normalize01(jnp.asarray(flat)))
    logits = rng.standard_normal((3, 2, 4, 16, 16)).astype(np.float32)
    attn = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    roll = tsal.attention_rollout(torch.from_numpy(attn))
    close(roll, jsal.attention_rollout(jnp.asarray(attn)))
    assert float(roll.min()) >= 0.0 and float(roll.max()) < 1.0
    close(tsal.last_layer_attention(torch.from_numpy(attn[-1])),
          jsal.last_layer_attention(jnp.asarray(attn[-1])))
    scores = rng.random((2, 50)).astype(np.float32)
    for s, (h, w) in ((50, (8, 8)), (50, (4, 5)), (50, (3, 4)),
                      (23, (4, 6))):              # pad, exact, pool
        close(tsal.tokens_to_grid(torch.from_numpy(scores[:, :s]), h, w),
              jsal.tokens_to_grid(jnp.asarray(scores[:, :s]), h, w))
    for src, dst in ((8, 32), (64, 32), (224, 64), (8, 224), (20, 13)):
        m = rng.random((2, src, src)).astype(np.float32)
        close(tsal.resize_mask(torch.from_numpy(m), dst, dst),
              jsal.resize_mask(jnp.asarray(m), dst, dst))
    m = rng.random((2, 30, 12)).astype(np.float32)
    close(tsal.resize_mask(torch.from_numpy(m), 16, 40),
          jsal.resize_mask(jnp.asarray(m), 16, 40))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((2, 64, 8)).astype(np.float32)), axis=-1))
    close(tsal.expert_utilization_map(torch.from_numpy(probs), 32, 32),
          jsal.expert_utilization_map(jnp.asarray(probs), 32, 32))


def _granite_pair(qk_scale=0.25):
    jc = dataclasses.replace(jconfigs.load_smoke("granite_3_2b"),
                             dtype="float32")
    tc = dataclasses.replace(tconfigs.load_smoke("granite_3_2b"),
                             dtype="float32")
    params = reference_params(jc, qk_scale)
    return jc, jbuild(jc), params, carried(tc, params)


def test_input_saliency_matches_the_reference():
    """|∂loss/∂embeddings| through the whole granite SMOKE stack, each
    package's loss_fn running its model's blocks from the injected
    embeddings, then onto a grid and resized."""
    jc, jm, params, model = _granite_pair()
    batch = tpipe.SyntheticLMData(model.cfg, 32, 2, seed=1).batch_at(0)
    n = jc.num_layers

    def jloss(p, b, emb):
        pos = jnp.broadcast_to(jnp.arange(emb.shape[1]), emb.shape[:2])
        x = emb
        for layer in range(n):
            blk = jax.tree.map(lambda a: a[layer], p["groups"])["block0"]
            x, _ = jtransformer.apply_block(blk, jc, "global", False, x, pos)
        h = jtransformer.rms_norm(x, p["final_norm"], jc.norm_eps)
        logits = jtransformer.logits_from_tied(p["embedding"], h,
                                               jc.vocab_size)
        return jtransformer.cross_entropy(logits, b["labels"])

    def tloss(m, b, emb):
        pos = torch.arange(emb.shape[1]).expand(emb.shape[:2])
        x = emb
        for blk in m.blocks:
            x = blk(x, pos)
        h = rms_norm(x, m.final_norm, m.cfg.norm_eps)
        return cross_entropy(logits_from_tied(m.embedding, h,
                                              m.cfg.vocab_size),
                             torch.as_tensor(b["labels"]))

    emb = np.asarray(params["embedding"])[batch["tokens"]]
    want = jax.jit(jsal.input_saliency, static_argnums=0)(jloss, params, {
        "embeddings": jnp.asarray(emb), "labels": jnp.asarray(
            batch["labels"])})
    with torch.no_grad():                 # input_saliency records its own
        got = tsal.input_saliency(tloss, model, {
            "embeddings": torch.from_numpy(emb), "labels": batch["labels"]})
    close(got, want)
    close(tsal.resize_mask(tsal.tokens_to_grid(got, 4, 8), 16, 16),
          jsal.resize_mask(jsal.tokens_to_grid(want, 4, 8), 16, 16))

    # the reference test's probe loss, on both
    def probe_j(p, b, e):
        return jnp.sum(e ** 2) * 1e-3

    def probe_t(p, b, e):
        return (e ** 2).sum() * 1e-3
    close(tsal.input_saliency(probe_t, None,
                              {"embeddings": torch.from_numpy(emb)}),
          jsal.input_saliency(probe_j, None, {"embeddings": jnp.asarray(emb)}))


# ---------------------------------------------------------------------------
# augmentation (by property: the noise is torch's, not JAX's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [0, 3])
def test_randomize_outside_roi(channels):
    imgs, _ = saliency_masks(4, 32, 32, seed=0)
    if channels:
        imgs = np.repeat(imgs[..., None], channels, axis=-1)
    rois = object_boxes(4, 32, 32, seed=1)
    rois[3] = (0, 0, 32, 32)                   # an ROI that covers it all
    out = taugment.randomize_outside_roi(torch.Generator().manual_seed(0),
                                         torch.from_numpy(imgs), rois)
    again = taugment.randomize_outside_roi(torch.Generator().manual_seed(0),
                                           torch.from_numpy(imgs), rois)
    ref = np.asarray(jaugment.randomize_outside_roi(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(rois)))
    assert torch.equal(out, again) and out.dtype == torch.float32
    out = out.numpy()
    for i in range(4):
        r0, c0, r1, c1 = rois[i]
        inside = np.zeros((32, 32), bool)
        inside[r0:r1, c0:c1] = True
        np.testing.assert_array_equal(out[i][inside], imgs[i][inside])
        # the reference keeps and replaces the same pixels
        np.testing.assert_array_equal(ref[i][inside], imgs[i][inside])
        noise = out[i][~inside]
        assert np.all(noise != imgs[i][~inside])
        assert np.all((noise >= 0) & (noise < 1))


def test_mix_augmented_replaces_selected_rows_only():
    tokens = np.random.default_rng(0).integers(0, 50, (6, 40)).astype(
        np.int32)
    selected = np.array([True, False, True, False, False, True])
    out = taugment.mix_augmented(torch.Generator().manual_seed(1),
                                 torch.from_numpy(tokens),
                                 torch.from_numpy(selected), 50).numpy()
    ref = np.asarray(jaugment.mix_augmented(
        jax.random.PRNGKey(1), jnp.asarray(tokens), jnp.asarray(selected),
        50))
    assert out.dtype == tokens.dtype
    for res in (out, ref):
        np.testing.assert_array_equal(res[~selected], tokens[~selected])
        assert np.all((res >= 0) & (res < 50))
        assert (res[selected] != tokens[selected]).mean() > 0.8


# ---------------------------------------------------------------------------
# the slice: producer → store → query
# ---------------------------------------------------------------------------

SEQ, N_MASKS = 64, 16
ROI = (0, SEQ // 4, SEQ, 3 * SEQ // 4)        # the key columns of the span
# Scenario 1's ranking (at these masks every score is 0: no key column of
# the span holds half the row's peak, and the bounds decide it), the same
# ranking over the attended pixels, and a CP filter that splits the masks
SLICE_SQL = {
    "scenario1": ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
                  "CP(mask, roi, (0.5, 1.0)) / AREA(roi) ASC LIMIT 5;"),
    "attended_topk": ("SELECT mask_id FROM MasksDatabaseView ORDER BY "
                      "CP(mask, roi, (0.01, 1.0)) / AREA(roi) ASC LIMIT 5;"),
    "cp_filter": ("SELECT mask_id FROM MasksDatabaseView WHERE "
                  "CP(mask, roi, (0.01, 1.0)) / AREA(roi) > 0.45;"),
}


@pytest.fixture(scope="module")
def produced():
    """Both packages' masks from one SyntheticLMData batch."""
    jc, jm, params, model = _granite_pair()
    batch = tpipe.SyntheticLMData(model.cfg, SEQ, N_MASKS, seed=0).batch_at(0)
    want = np.asarray(jax.jit(lambda p, t: jsal.last_layer_attention(
        jm.attention_maps(p, {"tokens": t})))(params, batch["tokens"]))
    got = tsal.last_layer_attention(model.attention_maps(batch)).numpy()
    return got, want


def test_produced_masks_agree(produced):
    got, want = produced
    assert got.shape == (N_MASKS, SEQ, SEQ) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() < 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_produced_masks_query_alike(produced, source):
    masks = produced[0] if source == "port" else produced[1]
    meta = np.zeros(N_MASKS, MASK_META_DTYPE)
    meta["mask_id"] = np.arange(N_MASKS)
    meta["image_id"] = np.arange(N_MASKS)
    meta["mask_type"] = 1
    cfg = dict(grid=16, num_bins=16, height=SEQ, width=SEQ)
    half = N_MASKS // 2
    j = JStore.create_memory(masks[:half], meta[:half], JCfg(**cfg))
    j.append(masks[half:], meta[half:])
    t = TStore.create_memory(masks[:half], meta[:half], TCfg(**cfg),
                             device="cpu")
    t.append(masks[half:], meta[half:])
    np.testing.assert_array_equal(t.chi_host(), j.chi_host())
    rois = np.tile(np.asarray(ROI, np.int32), (N_MASKS, 1))
    verified, sizes = 0, []
    for name, sql in SLICE_SQL.items():
        scan, _ = tq.run(sql, t, provided_rois=rois, use_index=False)
        for backend in ("host", "device"):
            (tres, tst) = tq.run(sql, t, provided_rois=rois, backend=backend)
            (jres, jst) = jq.run(sql, j, provided_rois=rois, backend=backend)
            if isinstance(jres, tuple):
                for a, b, c in zip(tres, jres, scan):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                    np.testing.assert_array_equal(a, c, err_msg=name)
            else:
                np.testing.assert_array_equal(tres, jres, err_msg=name)
                np.testing.assert_array_equal(tres, scan, err_msg=name)
            for f in STATS:
                assert getattr(tst, f) == getattr(jst, f), (name, f)
            verified += tst.n_verified
        sizes.append(len(scan[0]) if isinstance(scan, tuple) else len(scan))
    assert verified > 0          # the masks reach verification, not bounds only
    assert 0 < sizes[-1] < N_MASKS, sizes      # the filter splits them


def test_bf16_normalize01_reaches_one_like_the_reference():
    """A reference fault the port copies: in bfloat16, normalize01's
    ``1 - 1e-6`` shrink rounds to 1.0, so a bf16 mask's top value is 1.0,
    outside the paper's [0, 1) (input saliency on a bf16 model returns
    bf16 scores).  float32 keeps it below 1."""
    x = np.array([[0.5, 2.0, 3.0]], np.float32)
    got = tsal.normalize01(torch.from_numpy(x).bfloat16(), axis=(-1,))
    want = jsal.normalize01(jnp.asarray(x, jnp.bfloat16), axis=(-1,))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert float(got.max()) == 1.0
    assert float(tsal.normalize01(torch.from_numpy(x), axis=(-1,)).max()) < 1
