"""PyTorch port: the recurrent families (RG-LRU, Mamba-2 SSD) vs JAX.

recurrentgemma (a hybrid: RG-LRU blocks with one local-MQA block per
group of three; SMOKE is one group plus two RG-LRU tail layers) and
mamba2 (SSD blocks only).  As in ``test_torch_models.py``: one parameter
tree drawn with numpy in the JAX package's layout
(``test_torch_models.reference_params``) goes into both packages, the
same numpy inputs through both, and the tolerances are that file's —
``rtol = atol = 1e-5`` in float32 and ``2e-2`` in bfloat16, ``atol`` in
units of the reference tensor's scale.  Whole-model comparisons draw
``wq``/``wk`` at a quarter of the init scale (that file's docstring
says why); module-level ones keep the init's scales.

mamba2's bfloat16 gradients are held by another rule
(``assert_grads_close`` with ``jexact``): through its four SSD blocks
each package's bf16 gradient strays from the float32 gradient at the same
(bf16-rounded) weights by up to 5% of a leaf's scale on a few elements
(measured: the same RMS in both packages, leaf by leaf, e.g. 8.34e-03
and 8.57e-03 on ``conv_w``; largest 0.073 and 0.121 there), so the two
bf16 gradients cannot agree element by element at 2e-2.  Each leaf's
RMS distance from that float32 gradient must then be at most
``RMS_RATIO`` (1.5) times the reference's own: the port's bf16 gradient
is about as close to the exact one as the reference's (measured ratios
0.89–1.26, largest on ``a_log``).  The bound is the leaf's own noise,
whatever the size of its gradient, and
``test_the_rms_rule_rejects_a_wrong_gradient`` shows that it refuses a
leaf zeroed, negated, off by 10% or zeroed in one layer.  Its float32
gradients agree with the reference's to 1e-5, element by element.
"""

import dataclasses
import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import saliency as jsal
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import saliency as tsal
from repro_torch.launch import serve
from repro_torch.models import build_model as tbuild
from repro_torch.models import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import count_params
from test_torch_models import (B, DTYPES, S, assert_close, batch_for,
                               carried, pair, teacher_forcing, tensor, to_np)

FAMILIES = ("recurrentgemma_2b", "mamba2_13b")


def jdt(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def tdt(dtype):
    return torch.float32 if dtype == "float32" else torch.bfloat16


def draw(rng, shape, dtype, scale=1.0):
    """The same numpy draw as a JAX array and a torch tensor."""
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return jnp.asarray(x, jdt(dtype)), tensor(x, tdt(dtype))


RMS_RATIO = 1.5


def rms_rule(got, want, exact):
    """(holds, RMS of got − exact, RMS of want − exact): the port's bf16
    gradient leaf ``got`` is at most ``RMS_RATIO`` times as far from the
    float32 gradient ``exact`` as the reference's ``want`` is."""
    got, want, exact = (to_np(a).astype(np.float64)
                        for a in (got, want, exact))
    rms_t = float(np.sqrt(np.mean((got - exact) ** 2)))
    rms_j = float(np.sqrt(np.mean((want - exact) ** 2)))
    return rms_t <= RMS_RATIO * rms_j, rms_t, rms_j


def assert_grads_close(model, grads, jgrads, dtype, jexact=None):
    """The port's ``grads`` (``named_parameters()`` order) against the JAX
    package's tree ``jgrads``, leaf by leaf, element by element at
    ``tol`` of scale; or, given the reference's float32 gradient
    ``jexact``, each leaf by ``rms_rule`` (the module docstring)."""
    got = jax.tree.leaves(convert.reference_tree(model, grads))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    exact = ([None] * len(want) if jexact is None
             else jax.tree.leaves(jexact))
    assert len(got) == len(want) == len(exact)
    for g, (path, w), e in zip(got, want, exact):
        what = f"grad {jax.tree_util.keystr(path)}"
        if e is None:
            assert_close(g, w, dtype, what)
            continue
        holds, rms_t, rms_j = rms_rule(g, w, e)
        assert holds, (what, rms_t, rms_j)


def exact_grads(arch, params, batch):
    """The JAX package's float32 gradient of the loss at ``params``'
    values (bf16 leaves widened)."""
    jm = jbuild(dataclasses.replace(jconfigs.load_smoke(arch),
                                    dtype="float32"))
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    return jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        wide, {k: jnp.asarray(v) for k, v in batch.items()})


def layer0(arch, dtype, **overrides):
    """(JAX cfg, port cfg, layer 0's mixer params in both packages)."""
    jc, _, params, tc = pair(arch, dtype, **overrides)
    model = carried(tc, params)
    p_j = jax.tree.map(lambda a: a[0], params["groups"])["block0"]["mixer"]
    return jc, tc, p_j, model.blocks[0].mixer


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def test_softplus_is_jax_s_logaddexp():
    """Above 20 ``F.softplus`` returns x; JAX's adds log1p(exp(−x)).
    Values to a float32 ulp (the libraries' ``exp``/``log1p`` differ in
    the last bit), gradients (the sigmoid, 0.5 at 0) to 1e-6."""
    x = np.array([-80.0, -20.0, -1.5, 0.0, 1e-3, 3.0, 19.9, 20.5, 35.0, 90.0],
                 np.float32)
    got = tlayers.softplus(torch.from_numpy(x))
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2.4e-7,
                               atol=0)
    g = torch.from_numpy(x).requires_grad_(True)
    tlayers.softplus(g).sum().backward()
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(jax.grad(
        lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


def test_mixer_inits_match_the_reference_s():
    """``init_rglru``, ``init_ssm`` and ``init_cross_attention`` against the
    JAX package's inits at SMOKE size in bf16: the same names, shapes and
    dtypes (the per-channel vectors and ``out_norm`` f32), zeros and ones
    where the reference has them, and truncated normals within two of
    their scales elsewhere."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    for arch, jinit, tinit in (
            ("recurrentgemma_2b", jrglru.init_rglru, trglru.init_rglru),
            ("mamba2_13b", jssm.init_ssm, tssm.init_ssm),
            ("whisper_large_v3", jattn.init_cross_attention,
             tattn.init_cross_attention)):
        jc, tc = jconfigs.load_smoke(arch), tconfigs.load_smoke(arch)
        want = jlayers.split_params(jinit(key, jc, jnp.bfloat16))[0]
        mixer = tinit(gen, tc, torch.bfloat16, "cpu")
        got = dict(mixer.named_parameters())
        assert sorted(got) == sorted(want), arch
        for name, w in want.items():
            g, w = got[name].detach(), np.asarray(w, np.float32)
            assert tuple(g.shape) == w.shape, (arch, name)
            assert str(g.dtype).replace("torch.", "") == str(
                want[name].dtype), (arch, name)
            g = g.float().numpy()
            if not w.any() or (w == 1).all():
                np.testing.assert_array_equal(g, w)
                continue
            scale = getattr(mixer, "scales", {}).get(name, "fan_in")
            if scale == "fan_in":
                scale = 1.0 / np.sqrt(w.shape[-2])
            for x in (g, w):        # truncated at two of the init's scale
                assert x.any() and np.abs(x).max() <= 2.0 * scale * 1.01, \
                    (arch, name)


@pytest.mark.parametrize("s", [1, 2, 13, 32, 100])
def test_linear_scan_is_the_recurrence(s):
    """The doubling scan against the step-by-step loop (float64), at
    lengths that are and are not powers of two."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (2, s, 3)))
    b = torch.from_numpy(rng.standard_normal((2, s, 3)))
    h = torch.zeros(2, 3, dtype=torch.float64)
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trglru.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_functions_match_the_reference(dtype):
    """The conv (fresh and with a carried history), the gates, the scan
    at 13 and 32 steps, the block, and prefill + three decode steps with
    their caches, on layer 0's weights at the init's scales."""
    jc, tc, p_j, p_t = layer0("recurrentgemma_2b", dtype)
    rng = np.random.default_rng(7)
    w = jc.lru_width
    j_conv = jax.jit(jrglru._conv, static_argnums=0)
    j_block = jax.jit(jrglru.rglru_block, static_argnums=1)
    j_prefill = jax.jit(jrglru.rglru_prefill, static_argnums=1)
    j_decode = jax.jit(jrglru.rglru_decode, static_argnums=1)
    with torch.no_grad():
        for s in (13, 32):
            jx, tx = draw(rng, (B, s, w), dtype)
            for got, want in zip(trglru._conv(tc, p_t, tx),
                                 j_conv(jc, p_j, jx)):
                assert_close(got, want, dtype, f"conv {s}")
            for got, want in zip(trglru._gates(p_t, tx),
                                 jrglru._gates(p_j, jx)):
                assert got.dtype == torch.float32
                assert_close(got, want, dtype, f"gates {s}")
            assert_close(trglru.rglru_scan(p_t, tx),
                         jax.jit(jrglru.rglru_scan)(p_j, jx), dtype,
                         f"scan {s}")
            jx, tx = draw(rng, (B, s, jc.d_model), dtype)
            assert_close(trglru.rglru_block(p_t, tc, tx),
                         j_block(p_j, jc, jx), dtype, f"block {s}")
        jst, tst = draw(rng, (B, jc.conv_width - 1, w), dtype)
        jx, tx = draw(rng, (B, 5, w), dtype)
        for got, want in zip(trglru._conv(tc, p_t, tx, tst),
                             j_conv(jc, p_j, jx, jst)):
            assert_close(got, want, dtype, "conv with a carried history")

        jx, tx = draw(rng, (B, 12, jc.d_model), dtype)
        jcache = jrglru.init_rglru_cache(jc, B, jdt(dtype))
        tcache = trglru.init_rglru_cache(tc, B, tdt(dtype), "cpu")
        for k in ("h", "conv"):
            assert tcache[k].shape == jcache[k].shape
        assert tcache["h"].dtype == torch.float32
        jo, jcache = j_prefill(p_j, jc, jx[:, :9], jcache)
        to, tcache = trglru.rglru_prefill(p_t, tc, tx[:, :9], tcache)
        assert_close(to, jo, dtype, "prefill")
        for step in range(9, 12):
            for k in ("h", "conv"):
                assert_close(tcache[k], jcache[k], dtype, f"cache {k}")
            jo, jcache = j_decode(p_j, jc, jx[:, step:step + 1], jcache)
            to, tcache = trglru.rglru_decode(p_t, tc, tx[:, step:step + 1],
                                             tcache)
            assert_close(to, jo, dtype, f"decode {step}")
        assert tcache["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_matches_the_reference(dtype, chunk):
    """The chunked scan alone: 32 steps in 4 chunks and in 1, without and
    with an ``init_state`` (float32 in either model), then a sequence that
    does not divide into chunks is refused by both."""
    jc = dataclasses.replace(jconfigs.load_smoke("mamba2_13b"), dtype=dtype,
                             chunk_size=chunk)
    tc = dataclasses.replace(tconfigs.load_smoke("mamba2_13b"), dtype=dtype,
                             chunk_size=chunk)
    _, h, hp, n = tssm._dims(tc)
    rng = np.random.default_rng(11)
    jx, tx = draw(rng, (B, S, h, hp), dtype)
    jb, tb = draw(rng, (B, S, n), dtype, 0.5)
    jcc, tcc = draw(rng, (B, S, n), dtype, 0.5)
    jdtv, tdtv = draw(rng, (B, S, h), "float32")
    ja, ta = draw(rng, (h,), "float32")
    ja, ta = -jnp.exp(ja), -torch.exp(ta)
    jinit, tinit = draw(rng, (B, h, hp, n), "float32", 0.5)
    j_ssd = jax.jit(jssm.ssd_chunked, static_argnums=0)
    for init in (False, True):
        jy, jfinal = j_ssd(jc, jx, jdtv, jb, jcc, ja,
                           jinit if init else None)
        ty, tfinal = tssm.ssd_chunked(tc, tx, tdtv, tb, tcc, ta,
                                      tinit if init else None)
        assert ty.dtype == tx.dtype
        # the carry stays in x's dtype unless the init state sets it
        assert tfinal.dtype == (torch.float32 if init else tx.dtype)
        assert_close(ty, jy, dtype, f"y init={init}")
        assert_close(tfinal, jfinal, dtype, f"final init={init}")
    with pytest.raises(AssertionError):
        j_ssd(dataclasses.replace(jc, chunk_size=12), jx, jdtv, jb, jcc, ja)
    with pytest.raises(ValueError, match="not divisible"):
        tssm.ssd_chunked(dataclasses.replace(tc, chunk_size=12), tx, tdtv,
                         tb, tcc, ta)
    seg = rng.standard_normal((2, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tssm._segsum(torch.from_numpy(seg)).numpy(),
        np.asarray(jssm._segsum(jnp.asarray(seg))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_functions_match_the_reference(dtype):
    """The SiLU conv (fresh and with a carried history), the block over
    4 chunks, and prefill + three decode steps with their caches (the
    state f32 in both), on layer 0's weights at the init's scales."""
    jc, tc, p_j, p_t = layer0("mamba2_13b", dtype, chunk_size=8)
    d_inner, _, _, n = tssm._dims(tc)
    rng = np.random.default_rng(12)
    j_conv = jax.jit(jssm._conv, static_argnums=0)
    j_prefill = jax.jit(jssm.ssm_prefill, static_argnums=1)
    j_decode = jax.jit(jssm.ssm_decode, static_argnums=1)
    with torch.no_grad():
        jx, tx = draw(rng, (B, S, d_inner + 2 * n), dtype)
        jst, tst = draw(rng, (B, jc.conv_width - 1, d_inner + 2 * n), dtype)
        for hist in (False, True):
            got = tssm._conv(tc, p_t, tx[:, :5], tst if hist else None)
            want = j_conv(jc, p_j, jx[:, :5], jst if hist else None)
            for g, w in zip(got, want):
                assert_close(g, w, dtype, f"conv history={hist}")
        jx, tx = draw(rng, (B, S, jc.d_model), dtype)
        assert_close(tssm.ssm_block(p_t, tc, tx),
                     jax.jit(jssm.ssm_block, static_argnums=1)(p_j, jc, jx),
                     dtype, "block")
        jcache = jssm.init_ssm_cache(jc, B, jdt(dtype))
        tcache = tssm.init_ssm_cache(tc, B, tdt(dtype), "cpu")
        jo, jcache = j_prefill(p_j, jc, jx[:, :24], jcache)
        to, tcache = tssm.ssm_prefill(p_t, tc, tx[:, :24], tcache)
        assert_close(to, jo, dtype, "prefill")
        for step in range(24, 27):
            assert tcache["state"].dtype == torch.float32
            for k in ("state", "conv"):
                assert tcache[k].shape == jcache[k].shape
                assert_close(tcache[k], jcache[k], dtype, f"cache {k}")
            jo, jcache = j_decode(p_j, jc, jx[:, step:step + 1], jcache)
            to, tcache = tssm.ssm_decode(p_t, tc, tx[:, step:step + 1],
                                         tcache)
            assert_close(to, jo, dtype, f"decode {step}")


# ---------------------------------------------------------------------------
# the SMOKE decoders
# ---------------------------------------------------------------------------


def _twins(arch, dtype):
    jc, jm, params, tc = pair(arch, dtype, qk_scale=0.25)
    return jc, jm, params, carried(tc, params)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_decoder_matches_the_reference(arch, dtype):
    """logits, loss, the gradient of the loss with respect to every
    parameter, ``attention_maps`` (recurrentgemma's last local layer,
    which is not its last block; ``None`` for mamba2 in both packages),
    and prefill + three greedy decode steps against the JAX package's."""
    jc, jm, params, model = _twins(arch, dtype)
    batch = batch_for(jc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def forward(p, b):
        (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        return jm.logits(p, b)[0], loss, met, grads, jm.attention_maps(p, b)
    jlogits, jloss, jmet, jgrads, jmaps = forward(params, jbatch)
    with torch.no_grad():
        logits, _ = model.logits(batch)
    assert logits.dtype == model.dtype
    assert_close(logits, jlogits, dtype, "logits")
    loss, metrics = model.loss(batch)
    loss.backward()
    assert_close(loss, jloss, dtype, "loss")
    assert_close(metrics["ce"], jmet["ce"], dtype, "ce")
    noisy = arch == "mamba2_13b" and dtype == "bfloat16"
    assert_grads_close(model, [p.grad for p in model.parameters()], jgrads,
                       dtype, exact_grads(arch, params, batch) if noisy
                       else None)
    maps = model.attention_maps(batch)
    if arch == "mamba2_13b":
        assert maps is None and jmaps is None
    else:
        assert model.kinds[2] == "local" and model.kinds[-1] == "rglru"
        assert_close(maps, jmaps, dtype, "attention_maps")

    prompt = {"tokens": batch["tokens"][:, :8]}
    jcache = jm.init_cache(B, S + 8)
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(
        prompt["tokens"])}, jcache)
    tl, tcache = model.prefill(prompt, model.init_cache(B, S + 8))
    assert_close(tl, jl, dtype, "prefill")
    token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        jl, jcache = decode(params, jcache, jnp.asarray(token),
                            jnp.int32(8 + i))
        tl, tcache = model.decode_step(tcache, token, 8 + i)
        assert_close(tl, jl, dtype, f"decode {i}")
        token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _mamba2_bf16_grads():
    """mamba2 SMOKE's bf16 gradient leaves in the port, in the reference,
    and the reference's float32 gradient, as (name, got, want, exact)."""
    arch = "mamba2_13b"
    jc, jm, params, model = _twins(arch, "bfloat16")
    batch = batch_for(jc)
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model.loss(batch)[0].backward()
    got = jax.tree.leaves(convert.reference_tree(
        model, [p.grad for p in model.parameters()]))
    want = jax.tree_util.tree_leaves_with_path(jgrads)
    exact = jax.tree.leaves(exact_grads(arch, params, batch))
    return [(jax.tree_util.keystr(path), to_np(g).astype(np.float32),
             to_np(w), to_np(e))
            for g, (path, w), e in zip(got, want, exact)]


def _zero_layer(g):
    """A stacked leaf (layers first) with layer 1's gradient zeroed."""
    g = g.copy()
    g[1] = 0.0
    return g


FAULTS = {"zeroed": lambda g: 0.0 * g, "negated": lambda g: -g,
          "10% high": lambda g: 1.1 * g, "10% low": lambda g: 0.9 * g,
          "one layer zeroed": _zero_layer}


@pytest.mark.parametrize("fault", FAULTS)
def test_the_rms_rule_rejects_a_wrong_gradient(fault):
    """The planted fault in every leaf of the port's mamba2 bf16
    gradient, one leaf at a time: the rule that passes the true gradient
    (``test_decoder_matches_the_reference``) refuses each."""
    leaves = _mamba2_bf16_grads()
    assert len(leaves) == 11
    for name, got, want, exact in leaves:
        assert rms_rule(got, want, exact)[0], name
        if fault == "one layer zeroed" and not name.startswith("['groups']"):
            continue
        if fault == "one layer zeroed":
            assert got.shape[0] == 4, (name, got.shape)
        holds, rms_t, rms_j = rms_rule(FAULTS[fault](got), want, exact)
        assert not holds, (name, fault, rms_t, rms_j)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_equals_teacher_forcing(arch):
    """float32, the port's own init: prefill (the chunked scan, the
    associative scan) then decode (the one-step recurrences) reproduce the
    full-sequence logits — the reference's test_arch_smoke check."""
    cfg = dataclasses.replace(tconfigs.load_smoke(arch), dtype="float32",
                              chunk_size=8)
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 24))
    full, lp, decoded = teacher_forcing(model, tokens, 16, 32)
    np.testing.assert_allclose(to_np(lp), to_np(full[:, 15]), rtol=2e-2,
                               atol=2e-2)
    for i, ld in enumerate(decoded):
        np.testing.assert_allclose(to_np(ld), to_np(full[:, 16 + i]),
                                   rtol=2e-2, atol=2e-2)


def test_recurrentgemma_local_ring_fault_is_the_reference_s():
    """recurrentgemma SMOKE in float32, prompt 20 > window 16: its local
    layer's ring keeps the last 16 keys in slots 0..15 and decode writes
    position p to slot p % 16, over a key still inside the window (ROADMAP
    §3).  The port's decode logits equal the reference's at every step;
    with a prompt of 16 both stay on teacher forcing, with 20 they leave
    it."""
    jc, jm, params, model = _twins("recurrentgemma_2b", "float32")
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (B, 24))
    jfull, _ = jax.jit(jm.logits)(params, {"tokens": jnp.asarray(tokens)})
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    worst = {}
    for prompt in (16, 20):
        full, _, decoded = teacher_forcing(model, tokens, prompt, 32)
        assert_close(full, jfull, "float32", "teacher forcing")
        jcache = jm.init_cache(B, 32)
        _, jcache = prefill(params, {"tokens": jnp.asarray(
            tokens[:, :prompt])}, jcache)
        errs = []
        for i, pos in enumerate(range(prompt, 24)):
            jd, jcache = decode(params, jcache,
                                jnp.asarray(tokens[:, pos:pos + 1]),
                                jnp.int32(pos))
            assert_close(decoded[i], jd[:, 0], "float32", f"decode {pos}")
            errs.append(float(np.abs(to_np(decoded[i]) -
                                     to_np(jfull[:, pos])).max()))
        worst[prompt] = errs
    assert max(worst[16]) < 1e-3, worst
    assert min(worst[20]) > 100 * max(worst[16]), worst


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_saliency_matches_the_reference(arch):
    """|∂loss/∂embeddings| through the whole SMOKE stack (mamba2's only
    mask source): each package's loss runs its model's blocks from the
    injected embeddings; then onto a grid and resized."""
    jc, jm, params, model = _twins(arch, "float32")
    batch = batch_for(jc)
    kinds = list(jm.group_kinds) * jm.n_groups + list(jm.tail_kinds)

    def jloss(p, b, emb):
        pos = jnp.broadcast_to(jnp.arange(emb.shape[1]), emb.shape[:2])
        x = emb
        for i, kind in enumerate(kinds):
            x, _ = jtransformer.apply_block(jm._block_params(p, i), jc, kind,
                                            False, x, pos)
        h = jlayers.rms_norm(x, p["final_norm"], jc.norm_eps)
        return jlayers.cross_entropy(jlayers.logits_from_tied(
            p["embedding"], h, jc.vocab_size), b["labels"])

    def tloss(m, b, emb):
        pos = torch.arange(emb.shape[1]).expand(emb.shape[:2])
        x = emb
        for blk in m.blocks:
            x = blk(x, pos)
        h = tlayers.rms_norm(x, m.final_norm, m.cfg.norm_eps)
        return tlayers.cross_entropy(tlayers.logits_from_tied(
            m.embedding, h, m.cfg.vocab_size), torch.as_tensor(b["labels"]))

    emb = (np.asarray(params["embedding"])[batch["tokens"]] *
           np.float32(jc.embed_scale))
    want = jax.jit(jsal.input_saliency, static_argnums=0)(jloss, params, {
        "embeddings": jnp.asarray(emb), "labels": jnp.asarray(
            batch["labels"])})
    got = tsal.input_saliency(tloss, model, {
        "embeddings": torch.from_numpy(emb), "labels": batch["labels"]})
    assert_close(got, want, "float32", "saliency")
    assert_close(tsal.resize_mask(tsal.tokens_to_grid(got, 4, 8), 16, 16),
                 jsal.resize_mask(jsal.tokens_to_grid(want, 4, 8), 16, 16),
                 "float32", "grid")


# ---------------------------------------------------------------------------
# configs, converter, CLI
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def full_shapes(arch):
    cfg = jconfigs.load_arch(arch)
    return jax.eval_shape(lambda k: jbuild(cfg).init(k)[0],
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch, total", [("recurrentgemma_2b", 2_894_481_920),
                                         ("mamba2_13b", 1_343_790_080)])
def test_full_width_parameters_equal_the_reference_s(arch, total):
    """At full width and depth (on ``meta``, no storage): the parameter
    count, and every leaf's shape and dtype in the reference's layout,
    equal ``jax.eval_shape`` of the JAX package's init."""
    model = tbuild(tconfigs.load_arch(arch), "meta")
    want = full_shapes(arch)
    assert count_params(model) == total == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    got = convert.reference_tree(model, model.parameters())
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, got)) ==
            jax.tree.structure(jax.tree.map(lambda t: 0, want)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_convert_carries_the_tail_both_ways():
    """recurrentgemma SMOKE: 1 group of three layers and 2 RG-LRU tail
    layers, to the port and back, leaf for leaf; a tree with the wrong
    tail is refused."""
    jc, _, params, tc = pair("recurrentgemma_2b", "bfloat16")
    model = carried(tc, params)
    assert [blk.kind for blk in model.blocks] == ["rglru", "rglru", "local",
                                                  "rglru", "rglru"]
    assert model.blocks[3].mixer.w_x.shape == (64, 64)
    back = convert.reference_tree(model, model.parameters())
    assert sorted(back["tail"]) == ["block0", "block1"]
    for g, w in zip(jax.tree.leaves(jax.tree.map(to_np, back)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, to_np(w))
    tree = jax.tree.map(np.asarray, params)
    short = dict(tree, tail={"block0": tree["tail"]["block0"]})
    with pytest.raises(ValueError, match="tail layers"):
        convert.load_reference_params(tbuild(tc, "cpu"), short)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_cli_on_cpu(arch):
    cfg = tconfigs.load_smoke(arch)
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen",
                           "5"]) == 0
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"{cfg.name} on cpu: "
                               f"{count_params(model):,} parameters")
    assert lines[1].startswith("prefill 2x8:")
    assert lines[2].startswith("decoded 4 steps x2 in")
    res = serve.greedy_generate(model, serve.prompt_batch(cfg, 2, 8), 5)
    assert lines[3] == f"sample: {res['tokens'][0].tolist()}"
    # greedy in float32: each token is the argmax of the teacher-forced
    # logits
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prompt = serve.prompt_batch(cfg, 2, 8)
    res = serve.greedy_generate(model, prompt, 5)
    assert res["finite"] and res["tokens"].shape == (2, 5)
    seq = np.concatenate([prompt["tokens"], res["tokens"].numpy()], axis=1)
    with torch.no_grad():
        full, _ = model.logits({"tokens": seq})
    np.testing.assert_array_equal(full[:, 7:12].argmax(-1).numpy(),
                                  res["tokens"].numpy())
