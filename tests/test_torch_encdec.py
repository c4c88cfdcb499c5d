"""PyTorch port: the encoder-decoder family (whisper) vs JAX.

whisper SMOKE (2 encoder and 2 decoder layers, MHA, absolute sinusoidal
positions, a 32-token decoder context) and the cross-attention functions.
As in ``test_torch_models.py``: one parameter tree drawn with numpy in
the JAX package's layout (``enc``/``dec`` stacked over layers) goes into
both packages, the same numpy batches through both, at that file's
tolerances — ``rtol = atol = 1e-5`` in float32 and ``2e-2`` in bfloat16,
``atol`` in units of the reference tensor's scale — with ``wq``/``wk``
at a quarter of the init scale for whole-model comparisons.

Two reference behaviours are pinned, not repaired (ROADMAP §3): decode
past ``max_decode_len`` reuses the last position embedding and the last
self-KV slot, and ``cross_attention_maps`` takes its queries from the
final, normed decoder state rather than the last block's cross-attention
input.
"""

import dataclasses
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
from repro_torch import configs as tconfigs
from repro_torch.core import saliency as tsal
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models import convert
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.layers import (count_params, logits_from_tied,
                                       rms_norm)
from test_torch_models import (DTYPES, assert_close, carried, pair, tensor,
                               to_np)
from test_torch_recurrent import assert_grads_close, full_shapes

ARCH = "whisper_large_v3"
B, S_ENC, S_DEC = 2, 24, 16


def batch_for(cfg, seed=1, s_dec=S_DEC):
    rng = np.random.default_rng(seed)
    batch = {"audio_feats": rng.standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (B, s_dec)).astype(
            np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, s_dec)).astype(
            np.int32)}
    batch["labels"][0, :3] = -1
    return batch


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def twins(dtype, qk_scale=0.25, **overrides):
    jc, jm, params, tc = pair(ARCH, dtype, qk_scale=qk_scale, **overrides)
    return jc, jm, params, carried(tc, params)


def full_logits(model, batch):
    """Teacher-forced logits of every decoder position."""
    with torch.no_grad():
        h = model._decoder(batch["tokens"], model.encode(batch["audio_feats"]))
        return logits_from_tied(model.embedding, h, model.cfg.vocab_size)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_functions_match_the_reference(dtype):
    """``cross_kv`` and ``cross_attention`` on layer 0's cross weights at
    the init's scales, with the query blocks split (``attn_q_block`` 8)."""
    jc, _, params, model = twins(dtype, qk_scale=1.0, attn_q_block=8)
    p_j = jax.tree.map(lambda a: a[0], params["dec"])["cross"]
    p_t = model.dec[0].cross
    assert not hasattr(p_t, "q_norm")
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = rng.standard_normal((B, S_DEC, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, S_ENC, jc.d_model)).astype(np.float32)
    jkv = jax.jit(jattn.cross_kv)(p_j, jnp.asarray(enc, jdt))
    with torch.no_grad():
        tkv = tattn.cross_kv(p_t, tensor(enc, model.dtype))
        for k in ("k", "v"):
            assert_close(tkv[k], jkv[k], dtype, f"cross_kv {k}")
        got = tattn.cross_attention(p_t, model.cfg, tensor(x, model.dtype),
                                    tkv)
    want = jax.jit(jattn.cross_attention, static_argnums=1)(
        p_j, jc, jnp.asarray(x, jdt), jkv)
    assert_close(got, want, dtype, "cross_attention")


@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_matches_the_reference(dtype):
    """The encoder's states, the loss, the gradient with respect to every
    parameter, ``cross_attention_maps``, and prefill + three greedy decode
    steps against the JAX package's."""
    jc, jm, params, model = twins(dtype)
    batch = batch_for(jc)

    @jax.jit
    def forward(p, b):
        (loss, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        return (jm.encode(p, b["audio_feats"]), loss, met, grads,
                jm.cross_attention_maps(p, b))
    jenc, jloss, jmet, jgrads, jmaps = forward(params, jnp_batch(batch))
    with torch.no_grad():
        enc = model.encode(batch["audio_feats"])
    assert enc.dtype == model.dtype
    assert_close(enc, jenc, dtype, "encode")
    loss, metrics = model.loss(batch)
    loss.backward()
    assert set(metrics) == set(jmet) == {"ce", "loss"}
    assert_close(loss, jloss, dtype, "loss")
    assert_grads_close(model, [p.grad for p in model.parameters()], jgrads,
                       dtype)
    maps = model.cross_attention_maps(batch)
    assert maps.dtype == torch.float32
    assert maps.shape == (B, jc.num_heads, S_DEC, S_ENC)
    assert_close(maps, jmaps, dtype, "cross_attention_maps")

    prompt = {"audio_feats": batch["audio_feats"],
              "tokens": batch["tokens"][:, :8]}
    jcache = jm.init_cache(B, enc_len=S_ENC)
    tcache = model.init_cache(B, enc_len=S_ENC)
    for c_t, c_j in zip(tcache, [jax.tree.map(lambda a, i=i: a[i],
                                              jcache["dec"])
                                 for i in range(jc.dec_layers)]):
        assert {k: tuple(v.shape) for k, v in c_t.items()} == \
            {k: tuple(v.shape) for k, v in c_j.items()}
    jl, jcache = jax.jit(jm.prefill)(params, jnp_batch(prompt), jcache)
    tl, tcache = model.prefill(prompt, tcache)
    assert_close(tl, jl, dtype, "prefill")
    for i in range(jc.dec_layers):
        for k in ("xk", "xv"):
            assert_close(tcache[i][k], jcache["dec"][k][i], dtype, "cross kv")
    token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        jl, jcache = decode(params, jcache, jnp.asarray(token),
                            jnp.int32(8 + i))
        tl, tcache = model.decode_step(tcache, token, 8 + i)
        assert_close(tl, jl, dtype, f"decode {i}")
        token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)


def test_prefill_decode_equals_teacher_forcing():
    """float32, the port's own init: prefill then decode reproduce the
    full-sequence logits within the decoder's context."""
    cfg = dataclasses.replace(tconfigs.load_smoke(ARCH), dtype="float32")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = batch_for(cfg, s_dec=24)
    full = full_logits(model, batch)
    cache = model.init_cache(B, enc_len=S_ENC)
    lp, cache = model.prefill({"audio_feats": batch["audio_feats"],
                               "tokens": batch["tokens"][:, :16]}, cache)
    steps = [(lp[:, 0], full[:, 15])]
    for pos in range(16, 24):
        ld, cache = model.decode_step(cache, batch["tokens"][:, pos:pos + 1],
                                      pos)
        steps.append((ld[:, 0], full[:, pos]))
    for got, want in steps:
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2,
                                   atol=2e-2)


def test_decode_past_the_context_is_the_reference_s():
    """float32 SMOKE, context 32: a prompt of 30 and decode to position
    35.  Past 31 the reference's clamped slices reuse position row 31 and
    self-KV slot 31 (ROADMAP §3); the port's decode logits equal the
    reference's at every step, and they leave teacher forcing there (the
    full forward's sinusoidal rows 32..35 are not clamped), while within
    the context they stay on it."""
    jc, jm, params, model = twins("float32")
    batch = batch_for(jc, s_dec=36)
    full = full_logits(model, batch)
    prompt = {"audio_feats": batch["audio_feats"],
              "tokens": batch["tokens"][:, :30]}
    jcache = jm.init_cache(B, enc_len=S_ENC)
    _, jcache = jax.jit(jm.prefill)(params, jnp_batch(prompt), jcache)
    _, tcache = model.prefill(prompt, model.init_cache(B, enc_len=S_ENC))
    decode = jax.jit(jm.decode_step)
    errs = {}
    for pos in range(30, 36):
        tok = batch["tokens"][:, pos:pos + 1]
        jl, jcache = decode(params, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = model.decode_step(tcache, tok, pos)
        assert_close(tl, jl, "float32", f"decode {pos}")
        errs[pos] = float((tl[:, 0] - full[:, pos]).abs().max())
    assert max(errs[30], errs[31]) < 1e-3, errs
    assert min(errs[p] for p in range(32, 36)) > 0.1, errs


def test_cross_attention_maps_input_is_the_reference_s():
    """``cross_attention_maps`` equals the reference's, and both differ
    from the probabilities the last block's cross-attention actually
    uses (queries from its own ``ln_x`` input, not from the final normed
    state; ROADMAP §3)."""
    jc, jm, params, model = twins("float32")
    batch = batch_for(jc)
    maps = model.cross_attention_maps(batch)
    assert_close(maps, jax.jit(jm.cross_attention_maps)(
        params, jnp_batch(batch)), "float32", "maps")
    with torch.no_grad():
        enc = model.encode(batch["audio_feats"])
        x = model._embed(batch["tokens"]) + model._pe(S_DEC)[None]
        pos = model._positions(x)
        for blk in model.dec[:-1]:
            x = blk(x, pos, enc)
        blk = model.dec[-1]
        x = x + tattn.attention(blk.self_attn, model.cfg,
                                rms_norm(x, blk.ln1, model.cfg.norm_eps), pos, "global")
        q = tattn._proj(rms_norm(x, blk.ln_x, model.cfg.norm_eps), blk.cross.wq)
        used = torch.softmax(tattn._scores(q, tattn._proj(enc, blk.cross.wk)),
                             dim=-1)
    assert float((maps - used).abs().max()) > 1e-2
    masks = tsal.resize_mask(tsal.last_layer_attention(maps), 224, 224)
    assert masks.shape == (B, 224, 224)
    assert float(masks.min()) >= 0.0 and float(masks.max()) < 1.0


def test_full_width_parameters_equal_the_reference_s():
    """whisper-large-v3 at full width and depth on ``meta``: the count and
    every leaf's shape and dtype equal ``jax.eval_shape``'s."""
    model = tbuild(tconfigs.load_arch(ARCH), "meta")
    assert isinstance(model, EncDecLM)
    want = full_shapes(ARCH)
    assert count_params(model) == 1_534_732_800 == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(want))
    got = convert.reference_tree(model, model.parameters())
    assert (jax.tree.structure(jax.tree.map(lambda t: 0, got)) ==
            jax.tree.structure(jax.tree.map(lambda t: 0, want)))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_convert_carries_the_stacks_both_ways():
    jc, _, params, tc = pair(ARCH, "bfloat16")
    model = carried(tc, params)
    names = [n for n, _ in model.named_parameters()]
    assert "dec.1.self.wq" in names and "enc.0.attn.wo" in names
    back = convert.reference_tree(model, model.parameters())
    assert sorted(back) == ["dec", "dec_norm", "embedding", "enc",
                            "enc_norm"]
    for g, w in zip(jax.tree.leaves(jax.tree.map(to_np, back)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, to_np(w))
    tree = jax.tree.map(np.asarray, params)
    short = dict(tree, enc=jax.tree.map(lambda a: a[:1], tree["enc"]))
    with pytest.raises(ValueError, match="layers"):
        convert.load_reference_params(tbuild(tc, "cpu"), short)


def test_serve_cli_on_cpu():
    """The reference CLI's whisper branch: 64 frames of audio, then the
    token prompt; greedy tokens are the argmax of the teacher-forced
    logits in float32."""
    cfg = tconfigs.load_smoke(ARCH)
    out = io.StringIO()
    with redirect_stdout(out):
        assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8", "--gen",
                           "5"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("whisper-smoke on cpu: 180,992 parameters")
    assert lines[1].startswith("prefill 2x8:")
    assert lines[2].startswith("decoded 4 steps x2 in")
    prompt = serve.prompt_batch(cfg, 2, 8)
    assert prompt["audio_feats"].shape == (2, 64, cfg.d_model)
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    res = serve.greedy_generate(model, prompt, 5)
    assert lines[3] == f"sample: {res['tokens'][0].tolist()}"
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    res = serve.greedy_generate(model, prompt, 5)
    assert res["finite"] and res["tokens"].shape == (2, 5)
    seq = np.concatenate([prompt["tokens"], res["tokens"].numpy()], axis=1)
    full = full_logits(model, {"audio_feats": prompt["audio_feats"],
                               "tokens": seq})
    np.testing.assert_array_equal(full[:, 7:12].argmax(-1).numpy(),
                                  res["tokens"].numpy())
    assert jconfigs.load_smoke(ARCH).max_decode_len == cfg.max_decode_len
