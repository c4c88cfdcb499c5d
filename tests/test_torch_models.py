"""PyTorch port: configs, layers, attention and the dense decoder vs JAX.

One parameter tree in the JAX package's layout (stacked layer groups and
tail), drawn with numpy at the reference init's scales, goes into both
packages — the port's ``DecoderLM`` through ``models/convert.py`` — and
the same numpy batches go through both.  The JAX side runs under
``jax.jit`` where an eager call would compile its layer scan (or each
primitive) anew, and eagerly elsewhere.

Tolerances: ``rtol = atol = 1e-5`` in float32 and ``2e-2`` in bfloat16,
with ``atol`` in units of the reference tensor's scale (its largest
magnitude, when that is above 1): a float32 sum of terms of magnitude M
carries an absolute rounding error of the order of M's last bit however
small the sum, and the summation order of a GEMM differs between XLA's
and PyTorch's CPU kernels.  Probabilities and normalised masks (scale 1)
are held to the plain absolute tolerance.

At the reference's init scales the attention logits are large (the
fan-in of a ``(D, heads, head_dim)`` projection is its heads axis, so
smoke scores reach ±70) and the softmax is close to an argmax: the last
bit of a GEMM decides which key wins, and XLA's own jitted and eager
``attention_maps`` differ by 2.5e-5 in float32 and 0.35 in bf16 there.
The whole-model comparisons therefore draw ``wq`` and ``wk`` at a quarter
of that scale (scores of order one), for both packages alike; the
layer-level comparisons and the ring-fault test keep the init's scales.
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
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import load_reference_params, reference_tree
from repro_torch.models.layers import count_params

DENSE = ("granite_3_2b", "codeqwen15_7b", "qwen3_32b", "gemma3_27b",
         "internvl2_1b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 32


def to_np(x) -> np.ndarray:
    """A JAX array or torch tensor as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float32).astype(np.float64)


def assert_close(got, want, dtype: str, what: str = "") -> None:
    """``rtol = tol`` and ``atol = tol`` in units of the reference tensor's
    scale (its largest magnitude, when above 1): tol = 1e-5 in float32,
    2e-2 in bfloat16."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL[dtype]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def tensor(a, dtype=None) -> torch.Tensor:
    """numpy / JAX → torch (bf16 through its bit pattern)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


NORMS = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm", "dec_norm",
         "q_norm", "k_norm", "out_norm", "kv_norm", "norm")
# float32 in every model, drawn at the init's fan-in scale (the MoE router)
F32 = ("router",)
# the query and key projections ``qk_scale`` scales: GQA's, and MLA's
# query up-projection (its keys share ``w_ukv`` with the values)
QK = ("wq", "wk", "w_uq")
# per-channel vectors of the recurrent mixers (f32 in every model): the
# init's value, to which a draw of this scale is added
VECTORS = {"lam": (0.0, 1.0), "conv_b": (0.0, 0.1), "a_log": (0.0, 0.1),
           "dt_bias": (0.0, 0.1), "d_skip": (1.0, 0.1)}


@functools.lru_cache(maxsize=None)
def _param_shapes(arch: str):
    cfg = jconfigs.load_smoke(arch)
    return jax.eval_shape(lambda k: jbuild(cfg).init(k)[0],
                          jax.random.PRNGKey(0))


def reference_params(cfg, qk_scale: float = 1.0, seed: int = 0):
    """A parameter tree in the JAX package's layout (stacked groups,
    tail; an encoder-decoder's ``enc``/``dec`` stacks), drawn with numpy:
    the reference init's scales — truncated normal over its fan-in
    ``shape[-2]``, embedding rows at scale 1 — with norm weights nonzero
    (±0.1, so ``1 + weight`` is exercised; MLA's ``q_norm``/``kv_norm``
    and the MTP head's ``norm`` among them), the recurrent mixers'
    per-channel ``VECTORS`` at their init's values plus noise (``lam``
    truncated normal at scale 1) and ``wq``/``wk`` (MLA: ``w_uq``)
    further scaled by ``qk_scale``.  Leaves are numpy arrays in the reference's dtypes
    (norms, ``VECTORS`` and the MoE ``router`` float32)."""
    rng = np.random.default_rng(seed)
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    arch = next(a for a in jconfigs.ARCH_IDS
                if jconfigs.load_smoke(a).name == cfg.name)

    def draw(path, leaf):
        name = path[-1].key
        if name in NORMS:
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape),
                               jnp.float32)
        x = np.clip(rng.standard_normal(leaf.shape), -2.0, 2.0)
        if name in VECTORS:
            at, scale = VECTORS[name]
            return jnp.asarray(at + scale * x, jnp.float32)
        if name != "embedding":
            x = x / np.sqrt(leaf.shape[-2])
        if name in QK:
            x = x * qk_scale
        return jnp.asarray(x.astype(np.float32),
                           jnp.float32 if name in F32 else dtype)
    return jax.tree_util.tree_map_with_path(draw, _param_shapes(arch))


def pair(arch: str, dtype: str, qk_scale: float = 1.0, **overrides):
    """(JAX cfg, JAX model, param tree, port cfg)."""
    jc = dataclasses.replace(jconfigs.load_smoke(arch), dtype=dtype,
                             **overrides)
    tc = dataclasses.replace(tconfigs.load_smoke(arch), dtype=dtype,
                             **overrides)
    return jc, jbuild(jc), reference_params(jc, qk_scale), tc


def carried(tc, params, device="cpu"):
    return load_reference_params(tbuild(tc, device),
                                 jax.tree.map(np.asarray, params))


def batch_for(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1              # ignored positions
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_configs_equal_the_reference_field_for_field():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.SHAPES == jconfigs.SHAPES
    assert ([f.name for f in dataclasses.fields(tconfigs.ModelConfig)] ==
            [f.name for f in dataclasses.fields(jconfigs.ModelConfig)])
    jreg, treg = jconfigs.registry(), tconfigs.registry()
    assert list(treg) == list(jreg)
    for arch in jconfigs.ARCH_IDS:
        for load in ("load_arch", "load_smoke"):
            j = getattr(jconfigs, load)(arch)
            t = getattr(tconfigs, load)(arch)
            assert type(t).__module__.startswith("repro_torch.")
            assert dataclasses.asdict(t) == dataclasses.asdict(j), arch
            for prop in ("padded_vocab", "sub_quadratic", "pattern_layers",
                         "num_groups", "tail_layers"):
                assert getattr(t, prop) == getattr(j, prop), (arch, prop)
            for shape in jconfigs.SHAPES:
                assert t.supports_shape(shape) == j.supports_shape(shape)
        assert dataclasses.asdict(treg[arch]) == dataclasses.asdict(jreg[arch])


def test_granite_full_width_geometry():
    cfg = tconfigs.load_arch("granite_3_2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff) == (40, 2048, 32, 8, 64, 8192)
    assert (cfg.vocab_size, cfg.padded_vocab) == (49155, 49280)
    # the parameter count the chip smoke prints, from the shapes alone
    per_layer = (2 * cfg.d_model + 2 * cfg.d_model * cfg.num_heads * 64 +
                 2 * cfg.d_model * cfg.num_kv_heads * 64 +
                 3 * cfg.d_model * cfg.d_ff)
    total = cfg.padded_vocab * cfg.d_model + cfg.d_model + 40 * per_layer
    assert total == 2_533_787_648
    model = tbuild(cfg, "meta")              # shapes only, no storage
    assert count_params(model) == total
    assert len(model.blocks) == 40 and model.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_layers_match_the_reference(dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    jx, tx = jnp.asarray(x, jdt), tensor(x, tdt)
    assert_close(tlayers.rms_norm(tx, tensor(w), 1e-6),
                 jlayers.rms_norm(jx, jnp.asarray(w), 1e-6), dtype, "rms")
    assert tlayers.rms_norm(tx, tensor(w)).dtype == tdt
    assert_close(tlayers.silu(tx), jlayers.silu(jx), dtype, "silu")
    assert_close(tlayers.gelu(tx), jlayers.gelu(jx), dtype, "gelu")
    pos = np.stack([np.arange(6), np.arange(6) + 1000]).astype(np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_array_equal(tlayers.rope_frequencies(16, theta),
                                      jlayers.rope_frequencies(16, theta))
        assert_close(tlayers.apply_rope(tx, tensor(pos), theta),
                     jlayers.apply_rope(jx, jnp.asarray(pos), theta), dtype,
                     "rope")
    np.testing.assert_array_equal(tlayers.sinusoidal_positions(12, 8),
                                  jlayers.sinusoidal_positions(12, 8))
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mlp = {k: rng.standard_normal(s).astype(np.float32) * 0.25
           for k, s in (("gate", (16, 24)), ("up", (16, 24)),
                        ("down", (24, 16)))}
    jp = {k: jnp.asarray(v, jdt) for k, v in mlp.items()}
    tp = {k: tensor(v, tdt) for k, v in mlp.items()}
    jh, th = jnp.asarray(h, jdt), tensor(h, tdt)
    assert_close(tlayers.swiglu(tp, th), jlayers.swiglu(jp, jh), dtype,
                 "swiglu")
    assert_close(tlayers.gelu_mlp(tp, th), jlayers.gelu_mlp(jp, jh), dtype,
                 "gelu_mlp")
    emb = rng.standard_normal((32, 16)).astype(np.float32)
    toks = rng.integers(0, 30, (2, 5))
    assert_close(tlayers.embed(tensor(emb, tdt), tensor(toks)),
                 jlayers.embed(jnp.asarray(emb, jdt), jnp.asarray(toks)),
                 dtype, "embed")
    got = tlayers.logits_from_tied(tensor(emb, tdt), th, valid_vocab=30)
    want = jlayers.logits_from_tied(jnp.asarray(emb, jdt), jh,
                                    valid_vocab=30)
    np.testing.assert_array_equal(to_np(got)[..., 30:], to_np(want)[..., 30:])
    assert to_np(got)[..., 30:].max() < -1e38
    assert_close(got[..., :30], want[..., :30], dtype, "logits")
    labels = rng.integers(0, 30, (2, 5))
    labels[0, :2] = -1
    mask = rng.random((2, 5)) > 0.3
    for m in (None, mask):
        assert_close(
            tlayers.cross_entropy(got, tensor(labels),
                                  None if m is None else tensor(m)),
            jlayers.cross_entropy(want, jnp.asarray(labels),
                                  None if m is None else jnp.asarray(m)),
            "float32", "cross_entropy")


def test_param_init_draws_from_the_generator():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = tlayers.param(g1, (64, 4, 16), device="cpu").detach()
    b = tlayers.param(g2, (64, 4, 16), device="cpu").detach()
    assert torch.equal(a, b) and a.dtype == torch.float32
    # truncated at two standard deviations of the fan-in (shape[-2]) scale
    assert float(a.abs().max()) <= 2.0 / np.sqrt(4) + 1e-6
    assert abs(float(a.std()) * np.sqrt(4) - 0.88) < 0.05
    e = tlayers.param(g1, (8, 3), device="cpu", dtype=torch.bfloat16,
                      scale=1.0).detach()
    assert e.dtype == torch.bfloat16 and float(e.abs().max()) <= 2.0
    assert torch.equal(tlayers.param(g1, (3,), device="cpu", scale="zeros"),
                       torch.zeros(3))
    cfg = tconfigs.load_smoke("gemma3_27b")
    mixer = tattn.init_attention(torch.Generator().manual_seed(2), cfg,
                                 torch.bfloat16, "cpu")
    assert mixer.wq.shape == (64, 4, 16) and mixer.wo.shape == (4, 16, 64)
    assert mixer.wk.dtype == torch.bfloat16 and mixer.wk.any()
    assert mixer.q_norm.dtype == torch.float32 and not mixer.q_norm.any()
    model = tbuild(tconfigs.load_smoke("granite_3_2b"), "cpu").init(
        torch.Generator().manual_seed(0))
    again = tbuild(tconfigs.load_smoke("granite_3_2b"), "cpu").init(
        torch.Generator().manual_seed(0))
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if "ln" in name or "norm" in name:
            assert not p.any(), name


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, dtype", [("granite_3_2b", "float32"),
                                         ("gemma3_27b", "float32"),
                                         ("gemma3_27b", "bfloat16")])
def test_attention_functions_match_the_reference(arch, dtype):
    """Every attention function on one layer's weights at the init's
    scales: the chunked causal / bidirectional / local-stripe paths, the
    cache fill (both branches) and decode (global slots, the local ring).
    granite has no qk-norm; gemma has qk-norm and a 16-token window."""
    jc, _, params, tc = pair(arch, dtype, attn_q_block=8)
    p_j = jax.tree.map(lambda a: a[0], params["groups"])["block0"]["mixer"]
    model = carried(tc, params)
    p_t = model.blocks[0].mixer
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, tx = jnp.asarray(x, jdt), tensor(x, model.dtype)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jpos, tpos = jnp.asarray(pos), tensor(pos).long()
    # jitted: one compile each, where eager JAX compiles every primitive
    j_attention = jax.jit(jattn.attention, static_argnums=(1, 4))
    j_prefill = jax.jit(jattn.prefill_attention, static_argnums=(1, 4))
    j_decode = jax.jit(jattn.decode_attention, static_argnums=(1, 4))
    with torch.no_grad():
        for kind in ("global", "local"):
            assert_close(tattn.attention(p_t, tc, tx, tpos, kind),
                         j_attention(p_j, jc, jx, jpos, kind), dtype, kind)
        assert_close(tattn.bidirectional_attention(p_t, tc, tx, tpos),
                     jax.jit(jattn.bidirectional_attention,
                             static_argnums=1)(p_j, jc, jx, jpos), dtype,
                     "bidirectional")
        for kind, prompt in (("global", 12), ("local", 12), ("local", 20)):
            jcache = jattn.init_cache(jc, B, 24, kind, jdt)
            tcache = tattn.init_cache(tc, B, 24, kind, model.dtype, "cpu")
            assert tcache["k"].shape == jcache["k"].shape
            jo, jcache = j_prefill(p_j, jc, jx[:, :prompt],
                                   jpos[:, :prompt], kind, jcache)
            to, tcache = tattn.prefill_attention(
                p_t, tc, tx[:, :prompt], tpos[:, :prompt], kind, tcache)
            assert_close(to, jo, dtype, f"prefill {kind} {prompt}")
            for key in ("k", "v"):
                assert_close(tcache[key], jcache[key], dtype, "cache")
            for step in range(3):
                p = prompt + step
                jo, jcache = j_decode(p_j, jc, jx[:, p:p + 1], jnp.int32(p),
                                      kind, jcache)
                to, tcache = tattn.decode_attention(
                    p_t, tc, tx[:, p:p + 1], p, kind, tcache)
                assert_close(to, jo, dtype, f"decode {kind} {p}")
    for s, t, off, win in ((5, 5, 0, 0), (4, 9, 5, 3), (6, 6, 0, 2)):
        np.testing.assert_array_equal(
            tattn.causal_mask(s, t, off, win).numpy(),
            np.asarray(jattn.causal_mask(s, t, off, win)))


def test_repeat_kv_and_query_blocks_match_the_reference():
    rng = np.random.default_rng(6)
    k = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    np.testing.assert_array_equal(tattn.repeat_kv(tensor(k), 4).numpy(),
                                  np.asarray(jattn.repeat_kv(jnp.asarray(k),
                                                             4)))
    cfg = tconfigs.load_smoke("gemma3_27b")
    for block, s in ((1024, 32), (8, 32), (12, 32), (5, 7), (0, 9)):
        c = dataclasses.replace(cfg, attn_q_block=block)
        assert tattn._pick_block(c, s) == jattn._pick_block(c, s)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_decoder_matches_the_reference(arch, dtype):
    """logits, loss, prefill + two greedy decode steps and attention_maps
    with the same weights (``wq``/``wk`` at a quarter of the init scale)."""
    jc, jm, params, tc = pair(arch, dtype, qk_scale=0.25)
    model = carried(tc, params)
    batch = batch_for(jc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, aux = model.logits(batch)
        loss, metrics = model.loss(batch)

    @jax.jit                  # one compile, where eager compiles each scan
    def forward(p, b):
        return jm.logits(p, b)[0], jm.loss(p, b), jm.attention_maps(p, b)
    jlogits, (jloss, jmetrics), jmaps = forward(params, jbatch)
    assert logits.dtype == model.dtype and float(aux) == 0.0
    assert_close(logits, jlogits, dtype, "logits")
    assert_close(loss, jloss, dtype, "loss")
    assert_close(metrics["ce"], jmetrics["ce"], dtype, "ce")
    assert_close(model.attention_maps(batch), jmaps, dtype, "attention_maps")

    prompt = {k: (v[:, :8] if k == "tokens" else v) for k, v in batch.items()
              if k in ("tokens", "patches")}
    jcache = jm.init_cache(B, S + 8)
    jl, jcache = jm.prefill(params, {k: jnp.asarray(v)
                                     for k, v in prompt.items()}, jcache)
    tl, tcache = model.prefill(prompt, model.init_cache(B, S + 8))
    assert_close(tl, jl, dtype, "prefill")
    pos0 = 8 + (jc.num_patches or 0)
    token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)     # eager would compile its scan twice
    for i in range(2):
        jl, jcache = decode(params, jcache, jnp.asarray(token),
                            jnp.int32(pos0 + i))
        tl, tcache = model.decode_step(tcache, token, pos0 + i)
        assert_close(tl, jl, dtype, f"decode {i}")
        token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)


def teacher_forcing(model, tokens, prompt: int, cache_len: int):
    """(full-sequence logits, prefill logits, decode logits at prompt..)."""
    with torch.no_grad():
        full, _ = model.logits({"tokens": tokens})
    cache = model.init_cache(tokens.shape[0], cache_len)
    lp, cache = model.prefill({"tokens": tokens[:, :prompt]}, cache)
    decoded = []
    for pos in range(prompt, tokens.shape[1]):
        ld, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
        decoded.append(ld[:, 0])
    return full, lp[:, 0], decoded


def test_prefill_decode_consistency_dense():
    """Decode logits reproduce teacher forcing (granite, float32, the
    port's own init) — the reference's test_arch_smoke check."""
    cfg = dataclasses.replace(tconfigs.load_smoke("granite_3_2b"),
                              dtype="float32")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 12))
    full, lp, decoded = teacher_forcing(model, tokens, 8, 16)
    np.testing.assert_allclose(to_np(lp), to_np(full[:, 7]), rtol=2e-2,
                               atol=2e-2)
    for i, ld in enumerate(decoded):
        np.testing.assert_allclose(to_np(ld), to_np(full[:, 8 + i]),
                                   rtol=2e-2, atol=2e-2)


def test_local_window_ring_fault_is_the_reference_s():
    """gemma3 SMOKE in float32, prompt 20 > window 16: the local layers'
    ring keeps the last 16 keys in slots 0..15, and decode then writes
    position p to slot p % 16, over a key still inside the window.  The
    port's decode logits equal the reference's, and both leave teacher
    forcing (a prompt of 16 stays on it)."""
    jc, jm, params, tc = pair("gemma3_27b", "float32")
    model = carried(tc, params)
    tokens = np.random.default_rng(2).integers(0, jc.vocab_size, (B, 24))
    jfull, _ = jax.jit(jm.logits)(params, {"tokens": jnp.asarray(tokens)})
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    for prompt, faulty in ((16, False), (20, True)):
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
        if faulty:
            assert min(errs) > 0.5, errs       # off from the first step
        else:
            assert max(errs) < 1e-3, errs


def test_vlm_serve_cache_omits_the_patches_like_the_reference_s():
    """internvl2 SMOKE in float32 (``wq``/``wk`` at 1/4), 8 patches ahead
    of an 8-token prompt.  Both packages' serve paths size the cache
    prompt + gen, the patches not counted (the reference CLI's
    ``max_len``, ``greedy_generate`` here), so the 16-position prefill
    takes the ring branch of a global layer (its last slots kept) and
    every decode step writes the last slot.  ``greedy_generate``'s tokens equal the reference's decode on
    that cache; with fixed tokens the port's decode logits equal the
    reference's and leave teacher forcing, and a cache that counts the
    patches stays on it."""
    jc, jm, params, tc = pair("internvl2_1b", "float32", qk_scale=0.25)
    model = carried(tc, params)
    p0 = jc.num_patches
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab_size, (B, 12)).astype(np.int32)
    patches = rng.standard_normal((B, p0, jc.d_model)).astype(np.float32)
    prompt = {"tokens": tokens[:, :8], "patches": patches}
    jprompt = {k: jnp.asarray(v) for k, v in prompt.items()}
    jfull, _ = jax.jit(jm.logits)(params, {"tokens": jnp.asarray(tokens),
                                           "patches": jnp.asarray(patches)})
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)

    jl, jcache = prefill(params, jprompt, jm.init_cache(B, 8 + 5))
    token = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    want = [token]
    for i in range(4):
        jl, jcache = decode(params, jcache, token, jnp.int32(p0 + 8 + i))
        token = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        want.append(token)
    got = serve.greedy_generate(model, prompt, 5)["tokens"]
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate(want, axis=1))

    for slots, faulty in ((p0 + 12, False), (12, True)):
        _, jcache = prefill(params, jprompt, jm.init_cache(B, slots))
        _, tcache = model.prefill(prompt, model.init_cache(B, slots))
        errs = []
        for pos in range(8, 12):
            tok = tokens[:, pos:pos + 1]
            jd, jcache = decode(params, jcache, jnp.asarray(tok),
                                jnp.int32(p0 + pos))
            td, tcache = model.decode_step(tcache, tok, p0 + pos)
            assert_close(td[:, 0], jd[:, 0], "float32", f"decode {pos}")
            errs.append(float(np.abs(to_np(jd[:, 0]) -
                                     to_np(jfull[:, p0 + pos])).max()))
        if faulty:
            assert min(errs) > 0.5, errs       # off from the first step
        else:
            assert max(errs) < 1e-3, errs


@pytest.mark.parametrize("arch, total", [
    ("codeqwen15_7b", 7_811_108_864), ("qwen3_32b", 31_984_210_944),
    ("gemma3_27b", 27_008_335_616), ("internvl2_1b", 493_775_744)])
def test_dense_full_width_parameters_equal_the_reference_s(arch, total):
    """At full width and depth (on ``meta``, no storage): the parameter
    count (``chip_smoke.py``'s ``DENSE_PARAMS``) and every leaf's shape
    and dtype in the reference's layout equal ``jax.eval_shape`` of the
    JAX package's init."""
    model = tbuild(tconfigs.load_arch(arch), "meta")
    want = jax.eval_shape(lambda k: jbuild(jconfigs.load_arch(arch)).init(
        k)[0], jax.random.PRNGKey(0))
    assert count_params(model) == total == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    got = reference_tree(model, model.parameters())
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, got)) ==
            jax.tree.structure(jax.tree.map(lambda t: 0, want)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_convert_checks_names_and_shapes():
    jc, _, params, tc = pair("granite_3_2b", "float32")
    tree = jax.tree.map(np.asarray, params)
    bad = dict(tree, embedding=tree["embedding"][:-1])
    with pytest.raises(ValueError, match="embedding"):
        load_reference_params(tbuild(tc, "cpu"), bad)
    short = dataclasses.replace(tc, num_layers=3)
    with pytest.raises(ValueError, match="layer groups"):
        load_reference_params(tbuild(short, "cpu"), tree)


def test_remat_recomputes_to_the_same_gradients():
    cfg = dataclasses.replace(tconfigs.load_smoke("gemma3_27b"),
                              dtype="float32")
    batch = batch_for(cfg)
    grads = []
    for remat in (True, False):
        model = tbuild(dataclasses.replace(cfg, remat=remat), "cpu").init(
            torch.Generator().manual_seed(1))
        loss, _ = model.loss(batch)
        grads.append(torch.autograd.grad(loss, model.embedding)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_serve_cli_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve.main(["--arch", "granite_3_2b", "--smoke", "--device",
                           "cpu", "--batch", "2", "--prompt-len", "8",
                           "--gen", "5"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("granite-smoke on cpu: 164,416 parameters")
    assert lines[1].startswith("prefill 2x8:")
    assert lines[2].startswith("decoded 4 steps x2 in")
    cfg = tconfigs.load_smoke("granite_3_2b")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    res = serve.greedy_generate(model, serve.prompt_batch(cfg, 2, 8), 5)
    assert lines[3] == f"sample: {res['tokens'][0].tolist()}"
    assert res["finite"] and res["tokens"].shape == (2, 5)
    # greedy: each token is the argmax of the teacher-forced logits (in
    # float32, where cache and full forward agree to far below a tie)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    res = serve.greedy_generate(model, serve.prompt_batch(cfg, 2, 8), 5)
    seq = np.concatenate([serve.prompt_batch(cfg, 2, 8)["tokens"],
                          res["tokens"].numpy()], axis=1)
    with torch.no_grad():
        full, _ = model.logits({"tokens": seq})
    np.testing.assert_array_equal(full[:, 7:12].float().argmax(-1).numpy(),
                                  res["tokens"].numpy())
