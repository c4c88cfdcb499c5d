"""GQA attention: full/local variants, qk-norm, RoPE, KV cache.

The port of the JAX package's ``models/attention.py``, in plain
``torch.matmul``: the reference computes attention with ``einsum``
outside any Pallas kernel, and its rounding is kept step by step —
scores are cast to f32 after the compute-dtype Q·K product, masked with
``NEG_INF``, softmaxed in f32, and the probabilities cast back to V's
dtype before the P·V product.  (``scaled_dot_product_attention`` rounds
differently and is not used.)

* **Query blocks.**  Queries run in blocks of ``cfg.attn_q_block`` (an
  exact row softmax per block: each block sees all its keys).
* **Local layers slice K/V.**  A sliding-window layer attends only to the
  ``q_block + window`` keys a block can see.
* **KV repeat.**  K/V are repeated to the query-head count before the
  score product (head ``h`` reads KV head ``h // groups``).

Cache layout is ``(B, S_max, kv_heads, head_dim)``, one ``{"k", "v"}``
dict per attention layer, updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .layers import (NEG_INF, apply_rope, empty, init_rms, redraw, rms_norm,
                     merge_dims, shard_act, split_dim, write_seq)


class Attention(torch.nn.Module):
    """One GQA layer's weights, under the reference's parameter names and
    logical axes: ``wq`` (D, Hq, hd), ``wk``/``wv`` (D, Hkv, hd), ``wo``
    (Hq, hd, D), and with qk-norm ``q_norm``/``k_norm`` (hd,)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        self.wq = empty((d, hq, hd), ("embed", "q_heads", "head_dim"), dtype,
                        device)
        self.wk = empty((d, hkv, hd), ("embed", "kv_heads", "head_dim"),
                        dtype, device)
        self.wv = empty((d, hkv, hd), ("embed", "kv_heads", "head_dim"),
                        dtype, device)
        self.wo = empty((hq, hd, d), ("q_heads", "head_dim", "embed"), dtype,
                        device)
        if cfg.qk_norm:
            self.q_norm = init_rms(hd, device, ("head_dim",))
            self.k_norm = init_rms(hd, device, ("head_dim",))

    def init(self, generator) -> None:
        """Truncated-normal fan-in init of the projections (the norms stay
        zero: identity)."""
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, redraw(generator, getattr(self, name)))


def init_attention(generator, cfg, dtype, device) -> Attention:
    p = Attention(cfg, dtype, device)
    p.init(generator)
    return p


def _theta(cfg, kind: str) -> float:
    if kind == "local" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    return split_dim(x @ merge_dims(w, 1), -1, tuple(w.shape[1:]))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshd,hdo->bso")`` as one matmul."""
    return merge_dims(o, -2) @ merge_dims(wo, 0)


def _qkv(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
         kind: str):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if cfg.pos_embedding == "rope":
        theta = _theta(cfg, kind)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    q = shard_act(q, ("batch", "seq", "q_heads", None))
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    v = shard_act(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return shard_act(torch.repeat_interleave(k, groups, dim=2),
                     ("batch", "kv_seq", "heads", None))


def sqrt_f32(d: int) -> float:
    """sqrt(d) rounded to f32, as ``jnp.sqrt(d)`` computes it."""
    return float(np.sqrt(np.float32(d)))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,S,H,D) × (B,T,H,D) → (B,H,S,T) f32 scaled scores: the product in
    the compute dtype, then f32, then ÷ sqrt(D)."""
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
    return s.float() / sqrt_f32(q.shape[-1])


def map_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A mask map's (B,H,S,T) f32 scores from (B,S,H,D) × (B,T,H,D): the
    product *and* the ÷ sqrt(D) in the compute dtype, then f32 — the
    reference's maps divide by a weakly typed scalar before their cast."""
    s = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1))
    return (s / torch.tensor(sqrt_f32(q.shape[-1]), dtype=s.dtype)).float()


def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,H,S,T) × (B,T,H,D) → (B,S,H,D)."""
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


def _block_attend(qb, k, v, q_pos, k_pos, causal: bool, window: int):
    """One query block against a key slice.  qb: (B,bq,H,D), k/v:
    (B,T,H,D), q_pos: (bq,), k_pos: (T,).  Full heads (already repeated)."""
    scores = shard_act(_scores(qb, k), ("batch", "heads", None, "kv_seq"))
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=qb.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _pv(probs, v)


def _pick_block(cfg, s: int) -> int:
    bq = cfg.attn_q_block or s
    bq = min(bq, s)
    while s % bq:
        bq -= 1
    return max(bq, 1)


def _sdpa(q, k, v, cfg, *, causal: bool, window: int, offset: int = 0):
    """(B,S,Hq,D) × (B,T,Hkv,D) chunked grouped attention, f32 softmax."""
    s, hq = q.shape[1], q.shape[2]
    t, hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    bq = _pick_block(cfg, s)
    k_pos_all = torch.arange(t, device=q.device)
    outs = []
    for i in range(s // bq):
        qs = i * bq
        qb = q[:, qs:qs + bq]
        q_pos = torch.arange(qs, qs + bq, device=q.device) + offset
        if window > 0 and t > bq + window:
            # local layers: only the visible key stripe
            ks = max(qs + offset - window + 1, 0)
            klen = min(bq + window, t - ks)
            kb, vb = k[:, ks:ks + klen], v[:, ks:ks + klen]
            k_pos = torch.arange(ks, ks + klen, device=q.device)
        else:
            kb, vb, k_pos = k, v, k_pos_all
        outs.append(_block_attend(qb, kb, vb, q_pos, k_pos, causal, window))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return shard_act(out, ("batch", "seq", "heads", None))


def attention(p: Attention, cfg, x, positions, kind: str = "global"):
    """Training/prefill self-attention (causal; sliding window if local)."""
    q, k, v = _qkv(p, cfg, x, positions, kind)
    window = cfg.local_window if kind == "local" else 0
    out = _sdpa(q, k, v, cfg, causal=True, window=window)
    return _out(out, p.wo)


def bidirectional_attention(p: Attention, cfg, x, positions):
    """Encoder self-attention (whisper encoder)."""
    q, k, v = _qkv(p, cfg, x, positions, "global")
    out = _sdpa(q, k, v, cfg, causal=False, window=0)
    return _out(out, p.wo)


# ---------------------------------------------------------------------------
# KV cache (prefill + decode)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, kind: str, dtype, device):
    """Zeroed cache for one attention layer.  Local layers keep only a
    window-sized ring."""
    length = min(max_len, cfg.local_window) if (kind == "local" and
                                                cfg.local_window) else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_attention(p: Attention, cfg, x, positions, kind, cache):
    """Run self-attention AND fill the cache (positions 0..s).

    A local layer whose window is shorter than the prompt keeps the last
    ``length`` keys in slots 0..length−1, as the reference does; decode
    then writes position ``pos`` to slot ``pos % length``, which
    overwrites a key still inside the window unless the prompt length is
    a multiple of ``length`` (a reference fault, copied on purpose)."""
    s = x.shape[1]
    q, k, v = _qkv(p, cfg, x, positions, kind)
    window = cfg.local_window if kind == "local" else 0
    out = _sdpa(q, k, v, cfg, causal=True, window=window)
    length = cache["k"].shape[1]
    if length >= s:
        write_seq(cache["k"], 0, k)
        write_seq(cache["v"], 0, v)
    else:  # ring for local windows shorter than the prompt
        cache["k"], cache["v"] = k[:, -length:], v[:, -length:]
    return _out(out, p.wo), cache


def decode_attention(p: Attention, cfg, x, pos: int, kind: str, cache):
    """One-token decode against the cache at absolute position ``pos``.

    The new K/V go to slot ``pos`` (global layers; past the end, the last
    slot, where the reference's ``dynamic_update_slice`` clamps) or
    ``pos % length`` (local ring); the softmax masks out unwritten and
    out-of-window slots."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x,
                           torch.full((b, 1), pos, device=x.device), kind)
    length = cache["k"].shape[1]
    window = cfg.local_window if (kind == "local" and cfg.local_window) else 0
    slot = (pos % length) if window else min(pos, length - 1)
    k, v = cache["k"], cache["v"]
    write_seq(k, slot, k_new)
    write_seq(v, slot, v_new)
    hq, hkv = q.shape[2], k.shape[2]
    kf = repeat_kv(k, hq // hkv)
    vf = repeat_kv(v, hq // hkv)
    idx = torch.arange(length, device=x.device)
    if window:
        valid = (slot - idx) % length < min(pos + 1, window)
    else:
        valid = idx <= pos
    scores = shard_act(_scores(q, kf), ("batch", "heads", None, "kv_seq"))
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vf.dtype)
    return _out(_pv(probs, vf), p.wo), cache


def causal_mask(s: int, t: int, offset: int, window: int = 0,
                device="cpu") -> torch.Tensor:
    """(1,1,s,t) bool: key j visible from query i + offset."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > (qi - window)
    return m[None, None]


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder → encoder states)
# ---------------------------------------------------------------------------


def init_cross_attention(generator, cfg, dtype, device) -> Attention:
    """``wq``/``wk``/``wv``/``wo`` as a self-attention layer's (the one
    family with cross-attention, whisper, has no qk-norm)."""
    p = Attention(cfg, dtype, device)
    p.init(generator)
    return p


def cross_kv(p: Attention, enc_out):
    """The encoder states' keys and values, ``{"k", "v"}`` (B,T,Hkv,hd)."""
    return {"k": shard_act(_proj(enc_out, p.wk),
                           ("batch", "kv_seq", "kv_heads", None)),
            "v": shard_act(_proj(enc_out, p.wv),
                           ("batch", "kv_seq", "kv_heads", None))}


def cross_attention(p: Attention, cfg, x, kv):
    """Every query sees every encoder frame (no mask, no positions)."""
    out = _sdpa(_proj(x, p.wq), kv["k"], kv["v"], cfg, causal=False,
                window=0)
    return _out(out, p.wo)
