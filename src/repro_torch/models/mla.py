"""Multi-head Latent Attention (DeepSeek-V2/V3).

The port of the JAX package's ``models/mla.py``.  Projections (DeepSeek-V2
paper §2.1.1–2.1.3):

    c_q   = x W_dq                         (q_lora_rank)
    q     = RMS(c_q) W_uq     → per head: [q_nope (nope_dim) ; q_pe (rope_dim)]
    c_kv  = x W_dkv                        (kv_lora_rank)
    k_pe  = x W_kpe                        (rope_dim, shared across heads)
    k     = [RMS(c_kv) W_uk ; k_pe]        per head
    v     = RMS(c_kv) W_uv                 (v_head_dim per head)

Training and prefill materialise the per-head K/V, causal, in blocks of
queries (the reference's block choice, ``attention._pick_block``).  The
cache holds only the compressed ``{"ckv", "kpe"}`` — ``kv_lora_rank +
rope_dim`` values a position — and decode uses the *absorbed* form:
W_uk folds into the query and W_uv into the output, so a step attends in
latent space against the compressed cache.

Rounding kept from the reference: prefill adds the two score products in
the compute dtype, casts to float32 and *multiplies* by the float32
``1/sqrt(nope + rope)``; decode casts and *divides* by the float32
``sqrt(nope + rope)``; masked scores are −2e38 in both; probabilities
return to the compute dtype before the value product.
"""

from __future__ import annotations

import numpy as np
import torch

from .attention import _out, _pick_block, _proj, sqrt_f32
from .layers import NEG_INF, Params, apply_rope, rms_norm, shard_act, write_seq


def mla_spec(cfg, dtype) -> dict:
    """name → (shape, dtype, init scale, logical axes), the reference's
    ``init_mla`` (``q_norm``/``kv_norm`` are float32 RMS weights, zero =
    identity)."""
    d, h = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": ((d, qr), dtype, "fan_in", ("embed", "q_lora")),
        "q_norm": ((qr,), torch.float32, "zeros", ("q_lora",)),
        "w_uq": ((qr, h, nd + rd), dtype, "fan_in",
                 ("q_lora", "q_heads", "head_dim")),
        "w_dkv": ((d, kvr), dtype, "fan_in", ("embed", "kv_lora")),
        "kv_norm": ((kvr,), torch.float32, "zeros", ("kv_lora",)),
        "w_kpe": ((d, rd), dtype, "fan_in", ("embed", "head_dim")),
        "w_ukv": ((kvr, h, nd + vd), dtype, "fan_in",
                  ("kv_lora", "q_heads", "head_dim")),
        "w_o": ((h, vd, d), dtype, "fan_in", ("q_heads", "head_dim", "embed")),
    }


def init_mla(generator, cfg, dtype, device) -> Params:
    p = Params(mla_spec(cfg, dtype), device)
    p.init(generator)
    return p


def _queries(p, cfg, x, positions):
    nd = cfg.qk_nope_dim
    cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = _proj(cq, p["w_uq"])
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    return shard_act(q_nope, ("batch", "seq", "q_heads", None)), \
        shard_act(q_pe, ("batch", "seq", "q_heads", None))


def _latents(p, cfg, x, positions):
    ckv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope((x @ p["w_kpe"])[:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0]
    return (shard_act(ckv, ("batch", "seq", None)),
            shard_act(k_pe, ("batch", "seq", None)))


def _attend(p, cfg, x, positions, ckv, k_pe):
    """Materialised causal attention over query blocks → (B, S, d)."""
    s = x.shape[1]
    nd = cfg.qk_nope_dim
    q_nope, q_pe = _queries(p, cfg, x, positions)
    kv = _proj(ckv, p["w_ukv"])
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k_nope = shard_act(k_nope, ("batch", "kv_seq", "q_heads", None))
    v = shard_act(v, ("batch", "kv_seq", "q_heads", None))
    kt = k_nope.permute(0, 2, 3, 1)                        # (B, H, nd, T)
    pt = k_pe.transpose(1, 2)[:, None]                     # (B, 1, rd, T)
    vt = v.transpose(1, 2)                                 # (B, H, T, vd)
    bq = _pick_block(cfg, s)
    scale = float(np.float32(1.0) / np.float32(sqrt_f32(
        cfg.qk_nope_dim + cfg.qk_rope_dim)))
    k_pos = torch.arange(s, device=x.device)
    outs = []
    for i in range(s // bq):
        qs = i * bq
        qn = q_nope[:, qs:qs + bq].transpose(1, 2)         # (B, H, bq, nd)
        qp = q_pe[:, qs:qs + bq].transpose(1, 2)
        scores = (torch.matmul(qn, kt) + torch.matmul(qp, pt)).float()
        scores = shard_act(scores * scale,
                           ("batch", "q_heads", None, "kv_seq"))
        q_pos = torch.arange(qs, qs + bq, device=x.device)
        causal = k_pos[None, :] <= q_pos[:, None]
        scores = scores.masked_fill(~causal, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.matmul(probs, vt).transpose(1, 2))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return _out(out, p["w_o"])


def mla_attention(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Training/prefill: materialised per-head K/V, causal, chunked over
    query blocks."""
    return _attend(p, cfg, x, positions, *_latents(p, cfg, x, positions))


# -- compressed cache --------------------------------------------------------


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> dict:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                               dtype=dtype, device=device)}


def mla_prefill(p, cfg, x, positions, cache):
    """Prefill attention, and the prompt's latents written to cache slots
    0..S−1 (in place)."""
    ckv, k_pe = _latents(p, cfg, x, positions)
    out = _attend(p, cfg, x, positions, ckv, k_pe)
    write_seq(cache["ckv"], 0, ckv)
    write_seq(cache["kpe"], 0, k_pe)
    return out, cache


def mla_decode(p, cfg, x, pos: int, cache):
    """Absorbed one-token decode against the compressed (c_kv, k_pe) cache,
    written in place at slot ``pos`` (past the end, the last slot, where
    the reference's ``dynamic_update_slice`` clamps).

    q_lat = q_nope @ W_uk          (fold key up-proj into the query)
    score = q_lat · c_kv + q_pe · k_pe
    o_lat = probs · c_kv           (attend in latent space)
    out   = (o_lat @ W_uv) @ W_o   (fold value up-proj into output)
    """
    b = x.shape[0]
    nd = cfg.qk_nope_dim
    positions = torch.full((b, 1), pos, device=x.device)
    q_nope, q_pe = _queries(p, cfg, x, positions)
    ckv_new, kpe_new = _latents(p, cfg, x, positions)
    ckv, kpe = cache["ckv"], cache["kpe"]
    t = ckv.shape[1]
    slot = min(pos, t - 1)
    write_seq(ckv, slot, ckv_new)
    write_seq(kpe, slot, kpe_new)
    w_uk = p["w_ukv"][..., :nd]                          # (r, h, nd)
    w_uv = p["w_ukv"][..., nd:]                          # (r, h, vd)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (b, 1, h, r)
    scores = (torch.einsum("bshr,btr->bhst", q_lat, ckv) +
              torch.einsum("bshd,btd->bhst", q_pe, kpe))
    scores = scores.float() / sqrt_f32(cfg.qk_nope_dim + cfg.qk_rope_dim)
    valid = torch.arange(t, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btr->bshr", probs, ckv)
    out = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)
    return _out(out, p["w_o"]), cache
