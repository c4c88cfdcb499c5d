"""PyTorch port: the DeepSeek family (MoE, MLA, dense prefix, MTP) vs JAX.

deepseek-v2 and deepseek-v3 SMOKE: MLA attention in every layer, one
dense prefix layer (``first_k_dense``), MoE FFNs after it (8 routed
experts, top 2, 2 or 1 shared), and V3's multi-token-prediction head.
As in ``test_torch_models.py``: one parameter tree drawn with numpy in the
JAX package's layout (``reference_params``: the router float32, MLA's
``q_norm``/``kv_norm`` and the head's ``norm`` drawn as norms) goes into
both packages, the same numpy inputs through both, and the tolerances
are that file's — ``rtol = atol = 1e-5`` in float32 and ``2e-2`` in
bfloat16, ``atol`` in units of the reference tensor's scale.  Module
calls keep the init's scales; whole-model comparisons draw ``w_uq`` (MLA's
query projection, its counterpart of ``wq``) at a quarter of it, for both
packages alike: at the init's scale the two packages' float32 gradients
part by up to 1.8e-5 of scale (V3), the port's within 1.4e-5 and the
reference's within 7.3e-6 of the float64 gradient: rounding noise, which
scores of order one keep under 1e-5.

bfloat16 cannot be held element by element through the whole stack: a
router's top-2 choice flips where two experts' probabilities nearly tie,
and the packages' bf16 activations differ in their last bits (on these
inputs the first token whose choice differs is token 26 of 64 in V2 and
8 in V3; the rows after it part by up to 2.1 at a logit scale of ~30).  So
whole-model bf16 logits are held up to that token (``first_flip``: every
token before it routes alike in every layer, and so computes alike), the
loss's batch means at 2e-2, and bf16 gradients at module level
(``moe_ffn``, MLA: the same input bits, the same routing), element by
element.  Whole-stack gradients, prefill and decode are held in float32,
where no router's choice differs.

The reference reckons MoE capacity per call, so prefill drops tokens that
teacher forcing keeps (ROADMAP §3):
``test_moe_capacity_is_per_call_like_the_reference_s`` pins it.
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
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core import saliency as tsal
from repro_torch.launch import serve
from repro_torch.models import build_model as tbuild
from repro_torch.models import convert
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import count_params, rms_norm
from test_torch_models import (B, DTYPES, S, assert_close, batch_for,
                               carried, pair, tensor, to_np)
from test_torch_recurrent import draw, full_shapes, jdt

ARCHS = ("deepseek_v2_236b", "deepseek_v3_671b")


def mtp_batch(cfg, seed=1):
    """``batch_for``'s tokens and labels, and ``labels_mtp`` (the token
    after the label, −1 at the end) for a config with an MTP head."""
    batch = batch_for(cfg, seed)
    if cfg.mtp_depth:
        mtp = np.full_like(batch["labels"], -1)
        mtp[:, :-1] = batch["labels"][:, 1:]
        mtp[0, :3] = -1
        batch["labels_mtp"] = mtp
    return batch


def moe_layer(arch, dtype, **overrides):
    """(JAX cfg, port cfg, the first MoE layer's ``ffn`` and ``mixer``
    params in both packages): layer 1, the groups' first, in the
    reference's layout."""
    jc, _, params, tc = pair(arch, dtype, **overrides)
    model = carried(tc, params)
    p_j = jax.tree.map(lambda a: a[0], params["groups"])["block0"]
    blk = model.blocks[1]
    assert blk.use_moe and not model.blocks[0].use_moe
    return jc, tc, p_j, blk


def dropped(tc, probs) -> int:
    """Assignments past their expert's capacity, from the router's
    probabilities (T, E) of one call."""
    _, tope = tmoe.top_k(probs, tc.top_k)
    counts = torch.bincount(tope.reshape(-1), minlength=tc.num_experts)
    return int((counts - tmoe.capacity(tc, probs.shape[0])).clamp(
        min=0).sum())


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factor", [1.25, 100.0])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_the_reference(arch, dtype, factor):
    """``moe_ffn``'s output and aux loss on layer 1's weights at the init's
    scales, B × S = 64 tokens: at the configs' capacity factor (1.25:
    capacity 20 a call, and some assignments drop) and at 100 (capacity
    1,600: none drop); then its VJP (a cotangent for the output, 3 for
    the aux) into the input and every weight, the router's among them."""
    jc, tc, p_j, blk = moe_layer(arch, dtype, capacity_factor=factor)
    rng = np.random.default_rng(4)
    jx, tx = draw(rng, (B, S, jc.d_model), dtype)
    jo, ja = jax.jit(jmoe.moe_ffn, static_argnums=1)(p_j["ffn"], jc, jx)
    with torch.no_grad():
        to, ta = tmoe.moe_ffn(blk.ffn, tc, tx)
        probs = tmoe.router_probs(blk.ffn, tx.reshape(B * S, -1))
    n = dropped(tc, probs)
    assert (n > 0) if factor < 2 else (n == 0), n
    assert to.dtype == tx.dtype and ta.dtype == torch.float32
    assert_close(to, jo, dtype, f"moe out ({n} dropped)")
    assert_close(ta, ja, dtype, "aux")
    # the VJP of (out, aux) for one cotangent, into x and every weight
    jg, tg = draw(rng, (B, S, jc.d_model), dtype)
    jp, jgx = jax.jit(lambda p, x, g: jax.vjp(
        lambda p, x: jmoe.moe_ffn(p, jc, x), p, x)[1]((g, jnp.float32(3.0)))
    )(p_j["ffn"], jx, jg)
    tx.requires_grad_(True)
    to, ta = tmoe.moe_ffn(blk.ffn, tc, tx)
    torch.autograd.backward((to, ta), (tg, torch.tensor(3.0)))
    assert_close(tx.grad, jgx, dtype, "vjp x")
    for name, p in blk.ffn.named_parameters():
        want = functools.reduce(lambda t, k: t[k], name.split("."), jp)
        assert_close(p.grad, want, dtype, f"vjp {name}")


def test_combine_is_the_reference_s_scatter_add():
    """The combine alone, bf16, k = 6 contributions a token at scales
    2^-8..1 (order decides the rounding): bit-equal to the reference's
    ``zeros.at[st_].add(contrib)`` after its stable argsort by expert.
    Summed right to left instead, or in each token's choice order, the
    same contributions round differently."""
    rng = np.random.default_rng(0)
    t, k, e, d = 32, 6, 16, 64
    flat_e = np.stack([rng.permutation(e)[:k] for _ in range(t)]).reshape(-1)
    order = np.asarray(jnp.argsort(jnp.asarray(flat_e), stable=True))
    st_ = np.repeat(np.arange(t), k)[order]
    contrib = (rng.standard_normal((t * k, d)) *
               2.0 ** rng.uniform(-8, 0, (t * k, 1))).astype(np.float32)
    jc = jnp.asarray(contrib, jnp.bfloat16)
    want = to_np(jnp.zeros((t, d), jnp.bfloat16).at[jnp.asarray(st_)].add(jc))
    tc = tensor(np.asarray(jc))
    torder = torch.from_numpy(order).long()
    got = tmoe.combine(tc, torder, k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), want)
    # the test tells orders apart: a reversed sum, the choice order
    reverse = tmoe.combine(tc.flip(0), torder.flip(0), k)
    pos = torch.empty_like(torder)
    pos[torder] = torch.arange(t * k)
    mine = tc[pos.view(t, k)]
    chosen = functools.reduce(torch.add, mine.unbind(1))
    for other in (reverse, chosen):
        assert not np.array_equal(to_np(other), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_pick_the_reference_s_experts(arch):
    """A router whose columns come in equal groups ([v0, v1, v1, v2, v2,
    v3, v3, v3]), so probabilities tie exactly: the port's ``top_k`` picks
    ``jax.lax.top_k``'s experts (the lower id first) on every token, many
    of which split a tie at the k boundary, and ``moe_ffn`` equals the
    reference's (float32).  Swapping the weights of two tied experts moves
    the output: the tie decides."""
    jc, tc, p_j, blk = moe_layer(arch, "float32")
    rng = np.random.default_rng(5)
    v = rng.standard_normal((jc.d_model, 4)).astype(np.float32) * 0.5
    router = v[:, [0, 1, 1, 2, 2, 3, 3, 3]]
    p_j = dict(p_j["ffn"], router=jnp.asarray(router))
    with torch.no_grad():
        blk.ffn.router.copy_(torch.from_numpy(router))
    jx, tx = draw(rng, (B, S, jc.d_model), "float32")
    probs = tmoe.router_probs(blk.ffn, tx.reshape(B * S, -1))
    jprobs = jax.nn.softmax(jx.reshape(B * S, -1) @ jnp.asarray(router))
    want_w, want_e = jax.lax.top_k(jprobs, jc.top_k)
    got_w, got_e = tmoe.top_k(probs, jc.top_k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    assert_close(got_w, want_w, "float32", "top-k weights")
    # tokens whose k-th and (k+1)-th probabilities tie exactly
    srt = torch.sort(probs, dim=-1, descending=True).values
    split = int((srt[:, jc.top_k - 1] == srt[:, jc.top_k]).sum())
    assert split >= 8, split
    jo, _ = jax.jit(jmoe.moe_ffn, static_argnums=1)(p_j, jc, jx)
    with torch.no_grad():
        to, _ = tmoe.moe_ffn(blk.ffn, tc, tx)
        assert_close(to, jo, "float32", "moe out with ties")
        for name in ("gate", "up", "down"):
            w = getattr(blk.ffn, name)
            w[[1, 2]] = w[[2, 1]]
        swapped, _ = tmoe.moe_ffn(blk.ffn, tc, tx)
    assert float((swapped - to).abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_attention_matches_the_reference(dtype):
    """The training path unblocked and with query blocks of 8 (four
    blocks over S = 32), on layer 1's weights at the init's scales; then
    its VJP (blocks of 8) into the input and every weight."""
    for block in (1024, 8):
        jc, tc, p_j, blk = moe_layer("deepseek_v2_236b", dtype,
                                     attn_q_block=block)
        rng = np.random.default_rng(6)
        jx, tx = draw(rng, (B, S, jc.d_model), dtype)
        pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
        want = jax.jit(jmla.mla_attention, static_argnums=1)(
            p_j["mixer"], jc, jx, jnp.asarray(pos))
        with torch.no_grad():
            got = tmla.mla_attention(blk.mixer, tc, tx,
                                     torch.from_numpy(pos).long())
        assert got.dtype == tx.dtype
        assert_close(got, want, dtype, f"mla_attention block {block}")
    # the VJP into x and every weight, four query blocks
    jg, tg = draw(rng, (B, S, jc.d_model), dtype)
    jp, jgx = jax.jit(lambda p, x, g: jax.vjp(
        lambda p, x: jmla.mla_attention(p, jc, x, jnp.asarray(pos)), p, x
    )[1](g))(p_j["mixer"], jx, jg)
    tx.requires_grad_(True)
    tmla.mla_attention(blk.mixer, tc, tx, torch.from_numpy(pos).long()
                       ).backward(tg)
    assert_close(tx.grad, jgx, dtype, "vjp x")
    for name, p in blk.mixer.named_parameters():
        assert_close(p.grad, jp[name], dtype, f"vjp {name}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_prefill_cache_and_absorbed_decode_match_the_reference(dtype):
    """``mla_prefill`` of 12 positions into a 24-slot compressed cache
    (its output and both cache tensors), then 4 absorbed ``mla_decode``
    steps, each output and cache against the reference's."""
    jc, tc, p_j, blk = moe_layer("deepseek_v2_236b", dtype, attn_q_block=8)
    rng = np.random.default_rng(7)
    jx, tx = draw(rng, (B, 16, jc.d_model), dtype)
    pos = np.broadcast_to(np.arange(12), (B, 12)).astype(np.int32)
    jcache = jmla.init_mla_cache(jc, B, 24, jdt(dtype))
    tcache = tmla.init_mla_cache(tc, B, 24, tx.dtype, "cpu")
    for key in ("ckv", "kpe"):
        assert tcache[key].shape == jcache[key].shape
    jo, jcache = jax.jit(jmla.mla_prefill, static_argnums=1)(
        p_j["mixer"], jc, jx[:, :12], jnp.asarray(pos), jcache)
    decode = jax.jit(jmla.mla_decode, static_argnums=1)
    with torch.no_grad():
        to, tcache = tmla.mla_prefill(blk.mixer, tc, tx[:, :12],
                                      torch.from_numpy(pos).long(), tcache)
        assert_close(to, jo, dtype, "prefill")
        for p in range(12, 16):
            for key in ("ckv", "kpe"):
                assert_close(tcache[key], jcache[key], dtype, f"cache {key}")
            jo, jcache = decode(p_j["mixer"], jc, jx[:, p:p + 1],
                                jnp.int32(p), jcache)
            to, tcache = tmla.mla_decode(blk.mixer, tc, tx[:, p:p + 1], p,
                                         tcache)
            assert_close(to, jo, dtype, f"decode {p}")


# ---------------------------------------------------------------------------
# the SMOKE models
# ---------------------------------------------------------------------------


def port_routes(model, batch) -> list:
    """Each router's top-k expert ids (T, k) in the port's full-sequence
    forward, MoE layers in order, then (with ``labels``) the MTP head's."""
    cfg = model.cfg
    with torch.no_grad():
        x, pos = model._inputs(batch)
        out = []

        def route(blk, x):
            h = rms_norm(blk.mix(x, pos), blk.ln2, cfg.norm_eps)
            probs = tmoe.router_probs(blk.ffn, h.reshape(-1, cfg.d_model))
            out.append(tmoe.top_k(probs, cfg.top_k)[1].numpy())
        for blk in model.blocks:
            if blk.use_moe:
                route(blk, x)
            x = blk(x, pos)
        if cfg.mtp_depth:
            h = rms_norm(x, model.final_norm, cfg.norm_eps)
            labels = torch.as_tensor(batch["labels"]).long().clamp(min=0)
            hin = torch.cat([rms_norm(h, model.mtp.norm, cfg.norm_eps),
                             model.embedding[labels]], -1) @ model.mtp.proj
            route(model.mtp.block, hin)
    return out


def jax_routes(jc, jm, params, batch) -> list:
    """``port_routes`` from the reference's own functions."""
    kinds = (list(jm.prefix_kinds) + list(jm.group_kinds) * jm.n_groups +
             list(jm.tail_kinds))

    @jax.jit
    def routes(p, b):
        x, pos = jm._inputs(p, b)
        out = []

        def route(bp, x):
            x = x + jmla.mla_attention(bp["mixer"], jc, jlayers.rms_norm(
                x, bp["ln1"], jc.norm_eps), pos)
            h = jlayers.rms_norm(x, bp["ln2"], jc.norm_eps)
            probs = jax.nn.softmax(h.reshape(-1, jc.d_model).astype(
                jnp.float32) @ bp["ffn"]["router"], axis=-1)
            out.append(jax.lax.top_k(probs, jc.top_k)[1])
        for i, kind in enumerate(kinds):
            bp = jm._block_params(p, i)
            moe = i >= len(jm.prefix_kinds)
            if moe:
                route(bp, x)
            x, _ = jtransformer.apply_block(bp, jc, kind, moe, x, pos)
        if jc.mtp_depth:
            h = jlayers.rms_norm(x, p["final_norm"], jc.norm_eps)
            mtp = p["mtp"]
            emb = jlayers.embed(p["embedding"], jnp.maximum(b["labels"], 0))
            hin = jnp.concatenate([jlayers.rms_norm(h, mtp["norm"],
                                                    jc.norm_eps),
                                   emb.astype(h.dtype)], -1) @ mtp["proj"]
            route(mtp["block"], hin)
        return out
    return [np.asarray(r) for r in routes(
        params, {k: jnp.asarray(v) for k, v in batch.items()})]


def first_flip(jc, jm, params, model, batch) -> int:
    """The first token, in the flattened (B·S) order, at which any router
    picks other experts in the two packages (B·S if none).  Every token
    before it routes alike in every layer, and so computes alike: its
    attention reads earlier positions of its sequence, and its rank in an
    expert's queue counts earlier tokens only."""
    first = B * S
    for a, b in zip(port_routes(model, batch),
                    jax_routes(jc, jm, params, batch)):
        assert a.shape == b.shape
        differ = np.flatnonzero((a != b).any(-1))
        if len(differ):
            first = min(first, int(differ[0]))
    return first


@functools.lru_cache(maxsize=None)
def smoke_run(arch, dtype):
    """Both packages on the same weights (``w_uq`` at a quarter) and batch:
    the port's model, the batch, the first routing flip (``first_flip``)
    and the reference's logits, aux, loss metrics, grads and
    attention_maps."""
    jc, jm, params, tc = pair(arch, dtype, qk_scale=0.25)
    model = carried(tc, params)
    batch = mtp_batch(jc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def forward(p, b):
        (_, met), grads = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        return jm.logits(p, b), met, grads, jm.attention_maps(p, b)
    (jlogits, jaux), jmet, jgrads, jmaps = forward(params, jbatch)
    return dict(jc=jc, jm=jm, params=params, model=model, batch=batch,
                first=first_flip(jc, jm, params, model, batch),
                logits=jlogits, aux=jaux, met=jmet, grads=jgrads,
                maps=jmaps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_deepseek_smoke_matches_the_reference(arch, dtype):
    """``logits`` and its aux (the MoE layers' summed), ``loss`` with
    ``labels_mtp`` (``ce``, ``aux``, ``ce_mtp`` for V3, ``loss``) and
    ``attention_maps`` (``None`` for MLA in both).  In float32 no
    router's choice differs between the packages and the logits are held
    everywhere; in bf16 up to the first token whose choice differs
    (``first_flip``), the loss's means over the whole batch."""
    r = smoke_run(arch, dtype)
    model, batch, first = r["model"], r["batch"], r["first"]
    assert first == B * S if dtype == "float32" else first > 0
    with torch.no_grad():
        logits, aux = model.logits(batch)
        _, metrics = model.loss(batch)
    assert logits.dtype == model.dtype
    flat = logits.reshape(B * S, -1)[:first]
    assert_close(flat, to_np(r["logits"]).reshape(B * S, -1)[:first], dtype,
                 f"logits of the first {first} tokens")
    assert float(aux) > 0
    assert_close(aux, r["aux"], dtype, "aux")
    want = {"ce", "aux", "loss"} | ({"ce_mtp"} if r["jc"].mtp_depth
                                    else set())
    assert set(metrics) == set(r["met"]) == want
    for k in want:
        assert_close(metrics[k], r["met"][k], dtype, k)
    assert r["maps"] is None and model.attention_maps(batch) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(arch):
    """float32: the gradient of the loss (with ``labels_mtp``) with respect
    to every parameter — the dense prefix, the MoE layers' routers and
    experts, MLA's projections and norms, the MTP head — against
    ``jax.grad``, element by element."""
    r = smoke_run(arch, "float32")
    model = r["model"]
    for p in model.parameters():
        p.grad = None
    model.loss(r["batch"])[0].backward()
    got = jax.tree.leaves(convert.reference_tree(
        model, [p.grad for p in model.parameters()]))
    want = jax.tree_util.tree_leaves_with_path(r["grads"])
    assert len(got) == len(want)
    for g, (path, w) in zip(got, want):
        assert_close(g, w, "float32", f"grad {jax.tree_util.keystr(path)}")
        assert float(np.abs(to_np(g)).max()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    """float32: prefill of 8 tokens (capacity reckoned over the call's 16)
    and three decode steps (capacity 1) on the reference's greedy tokens,
    against the reference's prefill and decode; the caches are the
    compressed ``{"ckv", "kpe"}``."""
    r = smoke_run(arch, "float32")
    jm, params, model = r["jm"], r["params"], r["model"]
    prompt = r["batch"]["tokens"][:, :8]
    jcache = jm.init_cache(B, S + 8)
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(prompt)},
                                     jcache)
    tl, tcache = model.prefill({"tokens": prompt}, model.init_cache(B, S + 8))
    assert [set(c) for c in tcache] == [{"ckv", "kpe"}] * len(model.blocks)
    assert_close(tl, jl, "float32", "prefill")
    decode = jax.jit(jm.decode_step)
    for step in range(3):
        token = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
        jl, jcache = decode(params, jcache, jnp.asarray(token),
                            jnp.int32(8 + step))
        tl, tcache = model.decode_step(tcache, token, 8 + step)
        assert_close(tl, jl, "float32", f"decode {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forcing_when_nothing_drops(arch):
    """float32, the port's own init, capacity factor 100 (no assignment
    drops in any call): prefill's last logits equal the full-sequence
    logits there, and the absorbed decode steps reproduce teacher
    forcing."""
    from test_torch_models import teacher_forcing
    cfg = dataclasses.replace(tconfigs.load_smoke(arch), dtype="float32",
                              capacity_factor=100.0)
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 16))
    full, lp, decoded = teacher_forcing(model, tokens, 12, 16)
    assert_close(lp, full[:, 11], "float32", "prefill")
    for i, ld in enumerate(decoded):
        assert_close(ld, full[:, 12 + i], "float32", f"decode {12 + i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_is_per_call_like_the_reference_s(arch):
    """The reference reckons capacity per call (``max(int(1.25·T·k/E),
    1)``: prefill of 8 × 12 tokens gets 30, the whole 8 × 16 sequence 40,
    a decode step 2), so prefill and decode drop assignments that teacher
    forcing keeps.  float32, the JAX init ``PRNGKey(0)`` in both packages,
    tokens from ``default_rng(2)``: at the configs' 1.25 prefill's last
    logits leave teacher forcing by more than 1 in both packages, and the
    port's prefill, decode and full logits equal the reference's; at 100
    both stay on teacher forcing within 1e-4."""
    for factor in (1.25, 100.0):
        jc = dataclasses.replace(jconfigs.load_smoke(arch), dtype="float32",
                                 capacity_factor=factor)
        tc = dataclasses.replace(tconfigs.load_smoke(arch), dtype="float32",
                                 capacity_factor=factor)
        jm = jbuild(jc)
        params = jm.init(jax.random.PRNGKey(0))[0]
        model = carried(tc, params)
        tokens = np.random.default_rng(2).integers(0, jc.vocab_size,
                                                   (8, 16)).astype(np.int32)
        jfull = jax.jit(jm.logits)(params, {"tokens": jnp.asarray(tokens)})[0]
        jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(
            tokens[:, :12])}, jm.init_cache(8, 16))
        from test_torch_models import teacher_forcing
        full, lp, decoded = teacher_forcing(model, tokens, 12, 16)
        assert_close(full, jfull, "float32", "full")
        assert_close(lp, jl[:, 0], "float32", "prefill")
        decode = jax.jit(jm.decode_step)
        jerr = [float(np.abs(to_np(jl[:, 0]) - to_np(jfull[:, 11])).max())]
        terr = [float(np.abs(to_np(lp) - to_np(full[:, 11])).max())]
        for i, pos in enumerate(range(12, 16)):
            jd, jcache = decode(params, jcache,
                                jnp.asarray(tokens[:, pos:pos + 1]),
                                jnp.int32(pos))
            assert_close(decoded[i], jd[:, 0], "float32", f"decode {pos}")
            terr.append(float(np.abs(to_np(decoded[i]) -
                                     to_np(full[:, pos])).max()))
        if factor < 2:
            assert jerr[0] > 1 and terr[0] > 1, (jerr, terr)
        else:
            assert jerr[0] < 1e-4 and max(terr) < 1e-4, (jerr, terr)


def test_mtp_head_skips_two_norms_like_the_reference_s():
    """The reference's MTP loss (``DecoderLM.loss``,
    ``src/repro/models/transformer.py:303-316``) RMS-norms the final state
    but not the next token's embedding, and sends the head block's output
    to the tied head with no final norm; DeepSeek-V3 (arXiv:2412.19437
    §2.2) norms both inputs of the projection, and the main path norms
    with ``final_norm`` before the head.  The port copies it (ROADMAP §3):
    float32, the reference's parameters, the loss with ``labels_mtp``:
    the port's ``ce_mtp`` equals the reference's and the head rebuilt
    without the two norms, while the head rebuilt with them (an
    identity-weight RMS norm of the embedding, ``final_norm`` on the
    output) moves ``ce_mtp`` by more than 1e-2, and the embedding rows
    that enter the projection are not of unit RMS."""
    from repro_torch.models.layers import (cross_entropy, embed,
                                           logits_from_tied)
    r = smoke_run("deepseek_v3_671b", "float32")
    model, batch = r["model"], r["batch"]
    cfg, mtp = model.cfg, model.mtp
    with torch.no_grad():
        _, metrics = model.loss(batch)
        h, _ = model.hidden_states(batch)
        labels = torch.as_tensor(batch["labels"]).long()
        emb = embed(model.embedding, labels.clamp(min=0))
        positions = torch.arange(h.shape[1]).expand(h.shape[0], -1)

        def ce_mtp(norm_emb: bool, norm_out: bool) -> float:
            e = rms_norm(emb, torch.zeros(cfg.d_model), cfg.norm_eps) \
                if norm_emb else emb
            out = mtp.block(torch.cat([rms_norm(h, mtp.norm, cfg.norm_eps),
                                       e], dim=-1) @ mtp.proj, positions)
            if norm_out:
                out = rms_norm(out, model.final_norm, cfg.norm_eps)
            return float(cross_entropy(
                logits_from_tied(model.embedding, out, cfg.vocab_size),
                torch.as_tensor(batch["labels_mtp"])))

        as_reference, with_norms = ce_mtp(False, False), ce_mtp(True, True)
        rms = emb.square().mean(-1).sqrt()
    assert_close(metrics["ce_mtp"], r["met"]["ce_mtp"], "float32", "ce_mtp")
    assert abs(as_reference - float(metrics["ce_mtp"])) <= 1e-5 * max(
        1.0, as_reference)
    assert abs(with_norms - as_reference) > 1e-2, (with_norms, as_reference)
    assert float((rms - 1).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# expert-utilisation masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_utilization_harvest_matches_the_reference(arch):
    """The harvest's router probabilities — the blocks before the last MoE
    layer, its MLA and ``ln2``, then the float32 softmax of the router —
    against the same composition of the reference's functions
    (``apply_block`` over ``_block_params``), and the 224×224
    ``expert_utilization_map`` masks made from them (float32)."""
    jc, jm, params, tc = pair(arch, "float32")
    model = carried(tc, params)
    batch = batch_for(jc)
    kinds = (list(jm.prefix_kinds) + list(jm.group_kinds) * jm.n_groups +
             list(jm.tail_kinds))
    last = len(kinds) - 1

    @jax.jit
    def jprobs(p, b):
        x, pos = jm._inputs(p, b)
        for i in range(last):
            x, _ = jtransformer.apply_block(
                jm._block_params(p, i), jc, kinds[i],
                i >= len(jm.prefix_kinds), x, pos)
        bp = jm._block_params(p, last)
        x = x + jmla.mla_attention(bp["mixer"], jc, jlayers.rms_norm(
            x, bp["ln1"], jc.norm_eps), pos)
        h = jlayers.rms_norm(x, bp["ln2"], jc.norm_eps).astype(jnp.float32)
        return jax.nn.softmax(h @ bp["ffn"]["router"], axis=-1)
    want = jprobs(params, {"tokens": jnp.asarray(batch["tokens"])})
    got = model.router_probs(batch)
    assert got.shape == (B, S, jc.num_experts) and got.dtype == torch.float32
    assert_close(got, want, "float32", "router probs")
    masks = tsal.expert_utilization_map(got, 224, 224)
    jmasks = jsal.expert_utilization_map(want, 224, 224)
    assert masks.shape == (B, 224, 224)
    assert 0 <= float(masks.min()) and float(masks.max()) < 1
    assert_close(masks, jmasks, "float32", "masks")
    dense = tbuild(tconfigs.load_smoke("granite_3_2b"), "cpu")
    assert dense.router_probs(batch) is None


# ---------------------------------------------------------------------------
# configs, converter, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, total", [("deepseek_v2_236b", 235_217_146_880),
                                         ("deepseek_v3_671b", 681_709_778_944)])
def test_full_width_parameters_equal_the_reference_s(arch, total):
    """At full width and depth (on ``meta``, no storage): the parameter
    count, and every leaf's shape and dtype in the reference's layout
    (``prefix``, ``groups``, ``mtp``), equal ``jax.eval_shape`` of the JAX
    package's init."""
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


def test_convert_carries_the_prefix_and_mtp_both_ways():
    """V3 SMOKE: the dense prefix layer, two MoE groups and the MTP head,
    to the port and back, leaf for leaf; a tree without the head, or with
    its prefix layer moved into the groups, is refused."""
    jc, _, params, tc = pair("deepseek_v3_671b", "bfloat16")
    model = carried(tc, params)
    assert [blk.use_moe for blk in model.blocks] == [False, True, True]
    assert model.blocks[0].ffn.gate.shape == (64, 128)
    assert model.blocks[1].ffn.gate.shape == (8, 64, 32)
    assert model.mtp.block.use_moe and model.mtp.proj.shape == (128, 64)
    back = convert.reference_tree(model, model.parameters())
    assert sorted(back) == ["embedding", "final_norm", "groups", "mtp",
                            "prefix"]
    for g, w in zip(jax.tree.leaves(jax.tree.map(to_np, back)),
                    jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, to_np(w))
    tree = jax.tree.map(np.asarray, params)
    no_head = {k: v for k, v in tree.items() if k != "mtp"}
    with pytest.raises(ValueError, match="MTP head"):
        convert.load_reference_params(tbuild(tc, "cpu"), no_head)
    no_prefix = {k: v for k, v in tree.items() if k != "prefix"}
    with pytest.raises(ValueError, match="prefix layers"):
        convert.load_reference_params(tbuild(tc, "cpu"), no_prefix)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    """The serve CLI, unchanged, over both SMOKE configs; then, in float32
    with nothing dropped, greedy decode's tokens are the argmax of the
    teacher-forced logits."""
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
    cfg = dataclasses.replace(cfg, dtype="float32", capacity_factor=100.0)
    model = tbuild(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prompt = serve.prompt_batch(cfg, 2, 8)
    res = serve.greedy_generate(model, prompt, 5)
    assert res["finite"] and res["tokens"].shape == (2, 5)
    seq = np.concatenate([prompt["tokens"], res["tokens"].numpy()], axis=1)
    with torch.no_grad():
        full, _ = model.logits({"tokens": seq})
    np.testing.assert_array_equal(full[:, 7:12].argmax(-1).numpy(),
                                  res["tokens"].numpy())
