"""PyTorch port: training (rms_norm's VJP, AdamW, train steps) vs JAX.

One parameter tree in the JAX package's layout, drawn with numpy
(``test_torch_models.reference_params``, ``wq``/``wk`` at a quarter of the
init scale for whole-model comparisons), goes into both packages; the
same numpy batches (``SyntheticLMData``) go through both.

Tolerances.  Tensors: ``rtol = atol = tol`` with ``atol`` in units of the
reference tensor's scale (``test_torch_models.assert_close``): tol 1e-5
in float32 and 2e-2 in bfloat16.  ``rms_norm``'s VJP: float32 1e-6 of
scale; bfloat16 ``dx`` within one bf16 ulp.  ``apply_updates`` on
identical inputs: a few float32 ulps (rtol = atol = 1e-6 of scale), bf16
leaves within one bf16 ulp of the leaf's largest magnitude (see the
test).

Whole train steps in float32 add one allowance: Adam's first steps are
sign-like (``m/√v ≈ sign(g)``), so where a gradient element is under the
grads' rounding noise (|g| ≤ 1e-5 of the leaf's scale, at any step) the
two packages may move that parameter in opposite directions.  There the
params may differ by up to ``2.5 · Σ lr`` (twice the largest per-element
Adam update, ≈ 1.2, per step taken); everywhere else the float32
tolerance holds.  In bfloat16 the 2e-2 tolerance exceeds that allowance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLMData
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop
from test_torch_models import (TOL, assert_close, reference_params, tensor,
                               to_np)

DTYPES = ("float32", "bfloat16")
ARCH = "granite_3_2b"
OPT = dict(warmup_steps=2, total_steps=20)


def jdtype(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def tdtype(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at each |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def ref_leaves(model, values) -> list:
    """Port tensors (``named_parameters()`` order) as the reference's leaf
    list, in ``jax.tree.leaves`` order."""
    return jax.tree.leaves(jax.tree.map(
        to_np, convert.reference_tree(model, values)))


def twins(dtype, arch=ARCH, **overrides):
    """(JAX model, its params, port model carrying the same params, cfg)."""
    jc = dataclasses.replace(jconfigs.load_smoke(arch), dtype=dtype,
                             **overrides)
    tc = dataclasses.replace(tconfigs.load_smoke(arch), dtype=dtype,
                             **overrides)
    params = reference_params(jc, qk_scale=0.25)
    tm = convert.load_reference_params(tbuild(tc, "cpu"),
                                       jax.tree.map(np.asarray, params))
    return jbuild(jc), params, tm, jc


# ---------------------------------------------------------------------------
# rms_norm's hand-written VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (2, 3, 4, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_vjp_matches_the_reference(dtype, shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jx, jg = jnp.asarray(x, jdtype(dtype)), jnp.asarray(g, jdtype(dtype))
    jy, vjp = jax.vjp(lambda a, b: jlayers.rms_norm(a, b, 1e-6), jx,
                      jnp.asarray(w))
    jdx, jdw = vjp(jg)

    tx = tensor(np.asarray(jx)).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ty = tlayers.rms_norm(tx, tw, 1e-6)
    ty.backward(tensor(np.asarray(jg)))
    assert ty.dtype == tx.grad.dtype == tdtype(dtype)
    assert tw.grad.dtype == torch.float32
    if dtype == "float32":
        for got, want in ((ty, jy), (tx.grad, jdx), (tw.grad, jdw)):
            want = to_np(want)
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(to_np(got), want, rtol=1e-6,
                                       atol=1e-6 * scale)
    else:
        for got, want in ((ty, jy), (tx.grad, jdx)):
            got, want = to_np(got), to_np(want)
            assert (np.abs(got - want) <= bf16_ulp(want)).all()
        want = to_np(jdw)
        np.testing.assert_allclose(to_np(tw.grad), want, rtol=1e-6,
                                   atol=1e-6 * max(1.0, np.abs(want).max()))


def test_rms_norm_vjp_is_the_plain_forwards_gradient():
    """In float32 the hand-written VJP is the gradient of the plain
    forward (autograd through the variance branch), to f32 rounding."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 7, 32)).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.standard_normal(32)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 7, 32)).astype(np.float32))
    grads = []
    for fn in (tlayers.rms_norm,
               lambda a, b, eps: a * torch.rsqrt(
                   a.square().mean(-1, keepdim=True) + eps) * (1.0 + b)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fn(a, b, 1e-6).backward(g)
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_remat_recomputes_through_the_hand_written_vjp(monkeypatch):
    """``cfg.remat`` (``torch.utils.checkpoint`` per block) recomputes each
    block's norms through the Function: the same grads, bit for bit, and
    the VJP runs for every norm of every block."""
    calls = []
    backward = tlayers._RMSNorm.backward

    def counted(ctx, g):
        calls.append(g.shape)
        return backward(ctx, g)
    monkeypatch.setattr(tlayers._RMSNorm, "backward", staticmethod(counted))
    _, _, tm, jc = twins("float32")
    batch = SyntheticLMData(jc, 16, 2).batch_at(0)
    grads = {}
    for remat in (False, True):
        calls.clear()
        tm.cfg = dataclasses.replace(tm.cfg, remat=remat)
        for blk in tm.blocks:
            blk.cfg = tm.cfg
        _, _, g = tloop.make_loss_and_grads(tm)(batch)
        grads[remat] = [t.clone() for t in g]
        assert len(calls) == 2 * jc.num_layers + 1     # ln1, ln2, final
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_lr_at_and_global_norm_match_the_reference():
    for cfg in (dict(warmup_steps=5, total_steps=25),
                dict(warmup_steps=0, total_steps=3, min_lr_ratio=0.0),
                dict(warmup_steps=100, total_steps=10_000)):
        jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
        for step in (0, 1, 2, 4, 5, 6, 13, 24, 25, 26, 99, 100, 5000, 20000):
            want = float(jopt.lr_at(jc, jnp.asarray(step, jnp.int32)))
            got = topt.lr_at(tc, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32) * 3
              for s in ((4, 64, 128), (256, 64), (64,))]
    for dtype in DTYPES:
        j = [jnp.asarray(a, jdtype(dtype)) for a in leaves]
        want = float(jopt.global_norm(j))
        got = topt.global_norm([tensor(np.asarray(a)) for a in j])
        # a float32 sum of 49,216 squares, in another order
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])
@pytest.mark.parametrize("mode", ["master", "low_memory"])
def test_apply_updates_matches_the_reference_on_identical_inputs(mode,
                                                                 grad_scale):
    """Three AdamW steps, the same grads fed to both packages each step
    (clipped at grad_scale 1, unclipped at 1e-3): params, moments, master
    copies and ``lr`` agree to a few float32 ulps (XLA may fuse a product
    and a sum into one rounding).  The global norm sums its squares in
    another order (2e-6 relative: rtol 1e-5), and so does the clip scale
    it sets.  bf16 leaves agree within one bf16 ulp of the leaf's largest
    magnitude: a last-bit difference can round a bf16 moment the other way,
    and in the next ``b1·mu + (1 − b1)·g`` the terms can cancel, leaving
    that ulp on a much smaller value."""
    kw = dict(OPT) if mode == "master" else dict(
        OPT, moments_dtype="bfloat16", use_master=False)
    jc, tc = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    _, params, tm, cfg = twins("bfloat16")
    rng = np.random.default_rng(3)
    jstate = jopt.init_opt_state(params, jc)
    tstate = topt.init_opt_state(tm.parameters(), tc)
    names = [n for n, _ in tm.named_parameters()]
    for step in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(grad_scale * rng.standard_normal(p.shape)
                                  .astype(np.float32), p.dtype), params)
        flat = convert.reference_state(tm, jax.tree.map(np.asarray, grads))
        tgrads = [tensor(np.asarray(flat[n])) for n in names]
        params, jstate, jm = jax.jit(
            jopt.apply_updates, static_argnums=0)(jc, params, grads, jstate)
        tstate, tmetrics = topt.apply_updates(tc, list(tm.parameters()),
                                              tgrads, tstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tmetrics["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tmetrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    pairs = [(ref_leaves(tm, list(tm.parameters())),
              jax.tree.leaves(params)),
             (ref_leaves(tm, tstate.mu), jax.tree.leaves(jstate.mu)),
             (ref_leaves(tm, tstate.nu), jax.tree.leaves(jstate.nu))]
    if mode == "master":
        pairs.append((ref_leaves(tm, tstate.master),
                      jax.tree.leaves(jstate.master)))
    else:
        assert tstate.master == () and jstate.master == ()
    for got_leaves, want_leaves in pairs:
        assert len(got_leaves) == len(want_leaves) == 11
        for got, want in zip(got_leaves, want_leaves):
            bf16 = want.dtype == jnp.bfloat16
            want = to_np(want)
            assert got.shape == want.shape
            if bf16:
                assert (np.abs(got - want) <= bf16_ulp(
                    np.abs(want).max())).all()
            else:
                scale = max(1.0, float(np.abs(want).max()))
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6 * scale)
    # the updated params keep their dtypes: bf16 matrices, f32 norms
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 tbuild(tm.cfg, "meta").named_parameters()):
        assert p.dtype == q.dtype, name


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def close_after_steps(got, want, noisy, lr_sum, dtype, what):
    """The module docstring's rule: ``tol`` of scale everywhere, and up to
    ``2.5 · Σ lr`` more where a gradient element was under the noise."""
    tol = TOL[dtype]
    scale = max(1.0, float(np.abs(want).max()))
    allowed = tol * scale + tol * np.abs(want)
    if dtype == "float32":
        allowed = allowed + np.where(noisy, 2.5 * lr_sum, 0.0)
    err = np.abs(got - want)
    assert (err <= allowed).all(), (what, float(err.max()),
                                    int((err > allowed).sum()))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_steps_match_the_reference(dtype, steps):
    train_steps_match(ARCH, dtype, steps)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_13b",
                                  "whisper_large_v3", "deepseek_v2_236b",
                                  "deepseek_v3_671b"])
def test_a_train_step_of_each_family_matches_the_reference(arch):
    """One float32 step through ``train_loop`` for the hybrid, SSM,
    encoder-decoder and DeepSeek families (whisper's batches carry
    ``audio_feats``; V3's carry ``labels_mtp`` and its loss ``ce_mtp``)."""
    train_steps_match(arch, "float32", 1)


def train_steps_match(arch, dtype, steps):
    """``steps`` train steps of ``arch``'s SMOKE config in both packages
    from the same params and batches: grads, metrics, params and master
    copies within the module docstring's rule."""
    jm, params, tm, cfg = twins(dtype, arch)
    jc, tc = jopt.OptConfig(**OPT), topt.OptConfig(**OPT)
    data = SyntheticLMData(cfg, 16, 4)
    jstep = jax.jit(jloop.make_train_step(jm, jc))
    jgrads_fn = jax.jit(jloop.make_loss_and_grads(jm))
    tstep = tloop.make_train_step(tm, tc)
    jstate = jopt.init_opt_state(params, jc)
    tstate = topt.init_opt_state(tm.parameters(), tc)
    noisy = None
    lr_sum = 0.0
    for s in range(steps):
        batch = data.batch_at(s)
        _, _, jg = jgrads_fn(params, batch)
        if s == 0:          # identical params: the grads themselves agree
            _, _, tg = tloop.make_loss_and_grads(tm)(batch)
            for got, want in zip(ref_leaves(tm, tg), jax.tree.leaves(jg)):
                assert_close(got, want, dtype, "grads")
        below = [np.abs(to_np(g)) <= TOL["float32"] * max(
            1.0, float(np.abs(to_np(g)).max())) for g in jax.tree.leaves(jg)]
        noisy = below if noisy is None else [a | b for a, b in
                                              zip(noisy, below)]
        params, jstate, jmet = jstep(params, jstate, batch)
        tstate, tmet = tstep(tstate, batch)
        lr_sum += float(jmet["lr"])
        for k in ("loss", "ce", "grad_norm") + (("aux", "ce_mtp")
                                                 if cfg.mtp_depth else ()):
            assert_close(float(tmet[k]), float(jmet[k]), dtype, k)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    got = ref_leaves(tm, list(tm.parameters()))
    for g, w, n in zip(got, jax.tree.leaves(params), noisy):
        close_after_steps(g, to_np(w), n, lr_sum, dtype, "params")
    for g, w, n in zip(ref_leaves(tm, tstate.master),
                       jax.tree.leaves(jstate.master), noisy):
        close_after_steps(g, to_np(w), n, lr_sum, dtype, "master")


def test_microbatched_step_matches_single():
    """Gradient accumulation is loss-equivalent to the unaccumulated step
    (the reference's test_checkpoint.py bound: loss within 1e-4, params
    within 5e-3 after one Adam step)."""
    cfg = dataclasses.replace(tconfigs.load_smoke(ARCH), dtype="float32")
    opt_cfg = topt.OptConfig(warmup_steps=0, total_steps=10)
    batch = SyntheticLMData(cfg, seq_len=16, global_batch=8).batch_at(0)
    out = {}
    for n in (1, 4):
        model, opt = tloop.init_train_state(
            tbuild(cfg, "cpu"), torch.Generator().manual_seed(0), opt_cfg)
        _, m = tloop.make_train_step(model, opt_cfg, microbatches=n)(opt,
                                                                     batch)
        out[n] = (float(m["loss"]), [p.detach().clone()
                                     for p in model.parameters()])
    assert abs(out[1][0] - out[4][0]) < 1e-4
    err = max(float((a - b).abs().max()) for a, b in zip(out[1][1],
                                                         out[4][1]))
    assert err < 5e-3, f"accumulated step diverges: {err}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_accumulated_grads_match_the_reference(dtype):
    """Four microbatches: the f32 accumulated grads, the loss and the mean
    metrics against the reference's ``lax.scan``."""
    jm, params, tm, cfg = twins(dtype)
    batch = SyntheticLMData(cfg, 16, 8).batch_at(0)
    jl, jmet, jg = jax.jit(jloop.make_loss_and_grads(jm, 4))(params, batch)
    tl, tmet, tg = tloop.make_loss_and_grads(tm, 4)(batch)
    assert all(g.dtype == torch.float32 for g in tg)
    assert all(p.grad is None for p in tm.parameters())
    assert_close(float(tl), float(jl), dtype, "loss")
    for k in ("ce", "loss"):
        assert_close(float(tmet[k]), float(jmet[k]), dtype, k)
    for got, want in zip(ref_leaves(tm, tg), jax.tree.leaves(jg)):
        assert_close(got, want, dtype, "accumulated grads")


def test_split_batch_refuses_a_ragged_split():
    with pytest.raises(ValueError):
        tloop._split_batch({"tokens": np.zeros((6, 4))}, 4)


def test_pad_rows_of_the_tied_embedding_get_zero_grads():
    """Vocab 250 pads the tied embedding to 256 rows: the pad columns'
    logits are set in place, so their rows get no head grad and no lookup
    grad — zero, as the reference's ``jnp.where`` gives — and the
    embedding's grad (lookup + head) equals the reference's."""
    jm, params, tm, cfg = twins("float32", vocab_size=250)
    assert cfg.padded_vocab == 256 == tm.embedding.shape[0]
    batch = SyntheticLMData(cfg, 16, 4).batch_at(0)
    _, _, jg = jax.jit(jloop.make_loss_and_grads(jm))(params, batch)
    _, _, tg = tloop.make_loss_and_grads(tm)(batch)
    emb = tg[0]
    assert [n for n, _ in tm.named_parameters()][0] == "embedding"
    assert torch.equal(emb[250:], torch.zeros_like(emb[250:]))
    assert not np.asarray(jg["embedding"])[250:].any()
    assert_close(emb, jg["embedding"], "float32", "embedding grad")
    assert float(emb[:250].abs().sum()) > 0
