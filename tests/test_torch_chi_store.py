"""PyTorch port: CHI index and MaskStore vs the JAX package.

The same numpy masks (fixed seeds) go into both packages' index builders,
bounds and stores; CHI tables, bounds, chunk layouts, epochs and I/O
accounting must be identical.  The port runs on ``device="cpu"`` here,
which takes each kernel's plain PyTorch version.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chi as jchi
from repro.core import store as jstore_mod
from repro.data.masks import object_boxes, saliency_masks
from repro_torch.core import chi as tchi
from repro_torch.core import store as tstore_mod

B, H, W = 18, 32, 32
CFG = dict(grid=4, num_bins=8, height=H, width=W)


def _data(n, seed=0, id_base=0, h=H, w=W):
    boxes = object_boxes(n, h, w, seed=seed + 1)
    masks, _ = saliency_masks(n, h, w, seed=seed, attacked_fraction=0.3,
                              boxes=boxes)
    meta = np.zeros(n, jstore_mod.MASK_META_DTYPE)
    meta["mask_id"] = id_base + np.arange(n)
    meta["image_id"] = (id_base + np.arange(n)) // 2
    meta["mask_type"] = np.arange(n) % 3 + 1
    return np.asarray(masks, np.float32), meta


def _on_edges(masks, nb, seed):
    """Put ~30% of pixels exactly on the uniform bin edges k/nb (and on 0
    and 1.0, outside the interior edges)."""
    rng = np.random.default_rng(seed)
    out = masks.copy()
    pick = rng.random(out.shape) < 0.3
    out[pick] = (rng.integers(0, nb + 1, pick.sum()) / nb).astype(np.float32)
    return out


def _stores(n=B, seed=0, **kw):
    masks, meta = _data(n, seed=seed)
    j = jstore_mod.MaskStore.create_memory(masks, meta,
                                           jchi.CHIConfig(**CFG), **kw)
    t = tstore_mod.MaskStore.create_memory(masks, meta,
                                           tchi.CHIConfig(**CFG),
                                           device="cpu", **kw)
    return j, t, masks


CFGS = [dict(grid=4, num_bins=8, height=32, width=32),
        dict(grid=16, num_bins=16, height=64, width=48),
        dict(grid=7, num_bins=5, height=30, width=41),      # ragged
        dict(grid=8, num_bins=4, height=20, width=20,
             thresholds=(0.2, 0.5, 0.9))]


@pytest.mark.parametrize("cfg", CFGS)
def test_build_chi_matches_jax(cfg):
    h, w, nb = cfg["height"], cfg["width"], cfg["num_bins"]
    masks = _on_edges(_data(6, seed=3, h=h, w=w)[0], nb, seed=4)
    jcfg, tcfg = jchi.CHIConfig(**cfg), tchi.CHIConfig(**cfg)
    want = jchi.build_chi_np(masks, jcfg)
    np.testing.assert_array_equal(tchi.build_chi_np(masks, tcfg), want)
    np.testing.assert_array_equal(
        tchi.build_chi(torch.from_numpy(masks), tcfg).numpy(), want)
    np.testing.assert_array_equal(
        tchi.build_chi_delta(masks, tcfg, device="cpu"), want)
    np.testing.assert_array_equal(
        tchi.cell_histograms(torch.from_numpy(masks), tcfg).numpy(),
        np.asarray(jchi.cell_histograms(jnp.asarray(masks), jcfg)))
    assert tcfg.tier_grids == jcfg.tier_grids
    for g in tcfg.tier_grids:
        np.testing.assert_array_equal(tchi.tier_slice(want, cfg["grid"], g),
                                      jchi.tier_slice(want, cfg["grid"], g))


@pytest.mark.parametrize("seed", range(4))
def test_chi_bounds_match_jax(seed):
    cfg = dict(grid=8, num_bins=8, height=40, width=56)
    jcfg, tcfg = jchi.CHIConfig(**cfg), tchi.CHIConfig(**cfg)
    masks = _on_edges(_data(12, seed=seed, h=40, w=56)[0], 8, seed=seed)
    table = jchi.build_chi_np(masks, jcfg)
    rng = np.random.default_rng(50 + seed)
    r = np.sort(rng.integers(0, 41, (12, 2)), axis=1)
    c = np.sort(rng.integers(0, 57, (12, 2)), axis=1)
    rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
    rois[0] = (0, 0, 40, 56)                       # aligned full image
    rois[1] = (5, 7, 5, 30)                        # empty
    ttab = torch.from_numpy(table)
    for lv, uv in ((0.25, 0.75), (0.3, 0.61), (0.0, np.inf), (0.5, 0.5),
                   (0.125, 0.875), (-1.0, 2.0)):
        jlb, jub = jchi.chi_bounds(jnp.asarray(table), jcfg, rois, lv, uv)
        tlb, tub = tchi.chi_bounds(ttab, tcfg, rois, lv, uv)
        np.testing.assert_array_equal(tlb.numpy(), np.asarray(jlb))
        np.testing.assert_array_equal(tub.numpy(), np.asarray(jub))
        exact = np.array([jchi_exact(m, roi, lv, uv)
                          for m, roi in zip(masks, rois)])
        assert np.all(tlb.numpy() <= exact) and np.all(exact <= tub.numpy())


def jchi_exact(mask, roi, lv, uv):
    from repro.core.cp import cp_exact_np
    return cp_exact_np(mask, roi, lv, uv)


def _assert_same_store(j, t):
    assert t.epoch == j.epoch and len(t) == len(j)
    np.testing.assert_array_equal(t.meta, j.meta)
    assert [len(c) for c in t.chi_chunks] == [len(c) for c in j.chi_chunks]
    for tc, jc in zip(t.chi_chunks, j.chi_chunks):
        np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(t.chi_host(), j.chi_host())
    np.testing.assert_array_equal(t.resident_masks(), j.resident_masks())
    np.testing.assert_array_equal(t.chi_value_stats(), j.chi_value_stats())
    # device mirrors (torch tensors on the store's device) track the host
    np.testing.assert_array_equal(t.chi_table.numpy(), j.chi_host())
    np.testing.assert_array_equal(t.device_masks().numpy(),
                                  j.resident_masks())
    for g in t.cfg.tier_grids:
        np.testing.assert_array_equal(t.chi_tier_host(g), j.chi_tier_host(g))
        np.testing.assert_array_equal(t.chi_tier_table(g).numpy(),
                                      j.chi_tier_host(g))


def test_mutation_sequence_matches_jax():
    """create + append + update + delete, with every device cache
    materialized first so the incremental maintenance paths (append: cat;
    update: in-place index_copy_; delete: gather) all run."""
    cfg = dict(grid=8, num_bins=8, height=H, width=W)
    masks, meta = _data(B)
    j = jstore_mod.MaskStore.create_memory(masks, meta, jchi.CHIConfig(**cfg))
    t = tstore_mod.MaskStore.create_memory(masks, meta, tchi.CHIConfig(**cfg),
                                           device="cpu")
    _assert_same_store(j, t)
    new_masks, new_meta = _data(6, seed=7, id_base=1000)
    assert t.append(new_masks, new_meta) == j.append(new_masks, new_meta)
    _assert_same_store(j, t)
    upd = np.clip(masks[[2, 5, 11]] * 0.4 + 0.1, 0, 1)
    upd = _on_edges(upd, 8, seed=9)
    assert t.update([2, 5, 1003], np.concatenate([upd[:2], upd[2:]])) == \
        j.update([2, 5, 1003], np.concatenate([upd[:2], upd[2:]]))
    _assert_same_store(j, t)
    assert t.delete([0, 7, 1001]) == j.delete([0, 7, 1001])
    _assert_same_store(j, t)
    more, more_meta = _data(3, seed=11, id_base=2000)
    t.append(more, more_meta)
    j.append(more, more_meta)
    _assert_same_store(j, t)


def test_io_and_cache_stats_match_jax():
    j, t, _ = _stores()
    for s in (j, t):
        s.load(np.array([1, 4, 9]))
        s.load_rows(np.array([2, 3]), np.array([[4, 20], [0, 32]]))
    assert dataclasses.asdict(t.io) == pytest.approx(
        dataclasses.asdict(j.io), abs=10.0)   # wall_time_s is a clock
    for f in ("files_read", "bytes_read"):
        assert getattr(t.io, f) == getattr(j.io, f)
    assert t.io.modeled_ebs_time_s == j.io.modeled_ebs_time_s
    for s in (j, t):
        s.enable_cache(capacity_bytes=5 * H * W * 4)
        s.load(np.array([1, 2, 3]))
        s.load(np.array([2, 3, 4, 5, 6, 7]))
        s.update([3], s.resident_masks()[[3]] * 0.5)
        s.load(np.array([3, 1]))
    assert t.cache_stats.as_dict() == j.cache_stats.as_dict()
    assert t.io.bytes_read == j.io.bytes_read


def test_disk_tier_roundtrip_matches_jax(tmp_path):
    masks, meta = _data(B)
    j = jstore_mod.MaskStore.create_disk(str(tmp_path / "j"), masks, meta,
                                         jchi.CHIConfig(**CFG))
    t = tstore_mod.MaskStore.create_disk(str(tmp_path / "t"), masks, meta,
                                         tchi.CHIConfig(**CFG), device="cpu")
    new_masks, new_meta = _data(4, seed=5, id_base=500)
    for s in (j, t):
        s.append(new_masks, new_meta)
        s.load(np.array([0, 3, 19]))
    assert t.io.bytes_read == j.io.bytes_read
    assert t.io.files_read == j.io.files_read
    t2 = tstore_mod.MaskStore.open_disk(str(tmp_path / "t"), device="cpu")
    j2 = jstore_mod.MaskStore.open_disk(str(tmp_path / "j"))
    _assert_same_store(j2, t2)


def test_snapshot_consistency_matches_jax():
    j, t, masks = _stores()
    for s in (j, t):
        snap = s.snapshot()
        s.update([4], masks[[4]] * 0.3)
        with pytest.raises(Exception) as ei:
            snap.chi_table
        assert type(ei.value).__name__ == "StaleRunError"
        np.testing.assert_array_equal(snap.load(np.array([4])), masks[[4]])
    assert isinstance(t.snapshot().device, torch.device)


def test_from_reference_state_reproduces_the_jax_store():
    j, _, masks = _stores()
    new_masks, new_meta = _data(5, seed=3, id_base=300)
    j.append(new_masks, new_meta)
    state = dict(masks=j.resident_masks(), meta=j.meta, chi=j.chi_host(),
                 chunk_lens=[len(c) for c in j.chi_chunks], epoch=j.epoch,
                 cfg=dataclasses.asdict(j.cfg))
    t = tstore_mod.MaskStore.from_reference_state(state, device="cpu")
    _assert_same_store(j, t)
    assert not t.packed      # packed states: tests/test_torch_packed.py
    with pytest.raises(ValueError):
        tstore_mod.MaskStore.from_reference_state(
            dict(state, chunk_lens=[1]), device="cpu")
