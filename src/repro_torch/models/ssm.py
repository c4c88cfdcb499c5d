"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

The port of the JAX package's ``models/ssm.py``.  Training and prefill
use the chunked SSD algorithm: quadratic attention-like products *within*
chunks of ``cfg.chunk_size`` plus a linear recurrence over the chunks'
states; decode is the pure recurrence with an O(1) state ``(B, H, P, N)``
and a depthwise-conv history.

Block layout (mamba2-style):
    in_proj → [z (gate) | x | B | C | dt]
    depthwise causal conv over [x|B|C] (width 4), SiLU
    SSD(x·dt, A·dt, B, C) + D·x skip
    RMSNorm(gated by z) → out_proj

Dtypes follow the reference op for op: ``dt`` and the decays in f32,
``x·dt`` and the chunk products in the compute dtype, the inter-chunk
carry in ``x``'s dtype (bf16 in a bf16 model) unless an ``init_state``
sets it; the prefill cache holds it as f32 and decode's state is f32.
"""

from __future__ import annotations

import torch

from .layers import Params, rms_norm, shard_act, silu, softplus


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads or d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_spec(cfg, dtype) -> dict:
    """name → (shape, dtype, init scale, logical axes), the reference's
    ``init_ssm``."""
    d_inner, h, _, n = _dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = torch.float32
    return {
        "in_proj": ((cfg.d_model, 2 * d_inner + 2 * n + h), dtype, "fan_in",
                    ("embed", "mlp")),
        "conv_w": ((cfg.conv_width, conv_dim), dtype, 0.5, ("conv", "mlp")),
        "conv_b": ((conv_dim,), f32, "zeros", ("mlp",)),
        # A stored as log(−A): A = −exp(a_log) ∈ (−∞, 0)
        "a_log": ((h,), f32, "zeros", ("heads",)),
        "d_skip": ((h,), f32, "ones", ("heads",)),
        "dt_bias": ((h,), f32, "zeros", ("heads",)),
        "out_norm": ((d_inner,), f32, "zeros", ("mlp",)),
        "out_proj": ((d_inner, cfg.d_model), dtype, "fan_in",
                     ("mlp", "embed")),
    }


def init_ssm(generator, cfg, dtype, device) -> Params:
    p = Params(ssm_spec(cfg, dtype), device)
    p.init(generator)
    return p


def _split_proj(cfg, zxbcdt: torch.Tensor):
    d_inner, h, _, n = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)


def _conv(cfg, p, xbc: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Depthwise causal conv1d (width W), then SiLU.  ``conv_state``: the
    (B, W−1, C) history.  → (out, new history)."""
    w = cfg.conv_width
    if conv_state is None:
        # a zero history, joined by a cat: on a 2-d mesh torch 2.11's
        # DTensor gives F.pad's output a single placement
        conv_state = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                                 dtype=xbc.dtype, device=xbc.device)
    xbc_in = torch.cat([conv_state, xbc], dim=1)
    out = sum(xbc_in[:, i:i + xbc.shape[1]] * p["conv_w"][i]
              for i in range(w))
    return silu(out + p["conv_b"]).to(xbc.dtype), xbc_in[:, -(w - 1):]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): out[i, j] = Σ_{j<k≤i} x_k below the
    diagonal (and on it), −inf above."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype, as a mixed-dtype einsum computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def ssd_chunked(cfg, x, dt, b_in, c_in, a, init_state=None):
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H)  b_in/c_in: (B,S,N)  a: (H,) negative reals.
    Returns y: (B,S,H,P) in x's dtype and the final state (B,H,P,N)."""
    bsz, s, h, p_ = x.shape
    in_dtype = x.dtype
    n = b_in.shape[-1]
    cs = min(cfg.chunk_size, s)
    if s % cs:
        raise ValueError(f"seq {s} not divisible by chunk {cs}")
    nc = s // cs

    dt = softplus(dt.float())                                  # (B,S,H) ≥ 0
    dta = dt * a[None, None, :]                                # (B,S,H) ≤ 0
    xdt = x * dt[..., None].to(x.dtype)

    def r(t):  # (B,S,…) → (B,nc,cs,…)
        return t.reshape((bsz, nc, cs) + t.shape[2:])

    xc, dtac, bc, cc = r(xdt), r(dta), r(b_in), r(c_in)

    # 1) intra-chunk (quadratic within the chunk): C·Bᵀ, then the decays
    decay = torch.exp(_segsum(dtac.transpose(2, 3)))           # (B,nc,H,cs,cs)
    scores = (cc @ bc.transpose(-1, -2))[:, :, None] * decay.to(cc.dtype)
    y_diag = (scores @ xc.transpose(2, 3)).transpose(2, 3)     # (B,nc,cs,H,P)

    # 2) chunk-final states: Σ_j B_j ⊗ (decay to the chunk's end · x_j)
    a_cum = torch.cumsum(dtac, dim=2)                          # (B,nc,cs,H)
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    weighted = xc * decay_to_end.to(bc.dtype)[..., None]       # (B,nc,cs,H,P)
    states = weighted.permute(0, 1, 3, 4, 2) @ bc[:, :, None]  # (B,nc,H,P,N)

    # 3) inter-chunk recurrence over nc (a handful of chunks: a loop)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                # (B,nc,H)
    carry = (torch.zeros((bsz, h, p_, n), dtype=x.dtype, device=x.device)
             if init_state is None else init_state)
    entering = []                   # the state *entering* each chunk
    for c in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None].to(carry.dtype) + \
            states[:, c]
    entering = torch.stack(entering, dim=1)                    # (B,nc,H,P,N)

    # 4) inter-chunk contribution C·decay·state, in the order the
    # reference's einsum contracts it (the smaller intermediate first)
    dfs = torch.exp(a_cum).to(cc.dtype)                        # (B,nc,cs,H)
    if n < p_:
        cd = cc[..., None] * dfs[..., None, :]                 # (B,nc,cs,N,H)
        y_off = _matmul(cd.permute(0, 1, 4, 2, 3),
                        entering.transpose(-1, -2)).transpose(2, 3)
    else:
        y_off = _matmul(cc[:, :, None], entering.transpose(-1, -2))
        y_off = y_off.transpose(2, 3) * dfs[..., None]

    y = (y_diag + y_off).reshape(bsz, s, h, p_).to(in_dtype)
    return y, carry


def _gate_out(p, cfg, x, y, z):
    """SSD output ``y`` (with its D·x skip) gated by SiLU(z), normed and
    projected back to ``x``'s width."""
    y = rms_norm((y * silu(z)).to(x.dtype), p["out_norm"], cfg.norm_eps)
    return y @ p["out_proj"]


def _forward(p, cfg, x: torch.Tensor):
    """Block body over a whole sequence → (out, final state, conv history)."""
    d_inner, h, hp, n = _dims(cfg)
    b, s = x.shape[:2]
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])
    xbc, conv_state = _conv(cfg, p, xbc)
    xs, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = shard_act(xs.reshape(b, s, h, hp), ("batch", "seq", "heads", None))
    a = -torch.exp(p["a_log"].float())
    y, final = ssd_chunked(cfg, xs, dt + p["dt_bias"], b_in, c_in, a)
    y = y + xs * p["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, d_inner)
    return _gate_out(p, cfg, x, y, z), final, conv_state


def ssm_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba-2 block, training path.  x: (B,S,D) → (B,S,D)."""
    return _forward(p, cfg, x)[0]


# -- cache (decode) ----------------------------------------------------------


def init_ssm_cache(cfg, batch: int, dtype, device) -> dict:
    d_inner, h, hp, n = _dims(cfg)
    return {"state": torch.zeros((batch, h, hp, n), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner + 2 * n),
                                dtype=dtype, device=device)}


def ssm_prefill(p, cfg, x: torch.Tensor, cache):
    out, final, conv_state = _forward(p, cfg, x)
    return out, {"state": final.float(), "conv": conv_state}


def ssm_decode(p, cfg, x: torch.Tensor, cache):
    """One-token recurrence: h' = exp(dt·A)·h + dt·B·x ; y = C·h' + D·x."""
    d_inner, h, hp, n = _dims(cfg)
    bsz = x.shape[0]
    z, xbc, dt = _split_proj(cfg, x @ p["in_proj"])           # (B,1,…)
    xbc, conv_state = _conv(cfg, p, xbc, cache["conv"])
    xs, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    xs = xs.reshape(bsz, h, hp)
    dt = softplus(dt[:, 0] + p["dt_bias"])                     # (B,H) f32
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt * a[None, :])                         # (B,H)
    b_f, x_f = b_in[:, 0].float(), xs.float()
    if n < hp:                      # the reference einsum's order
        dbx = (dt[:, :, None] * b_f[:, None, :])[:, :, None, :] * \
            x_f[..., None]
    else:
        dbx = (dt[:, :, None] * x_f)[..., None] * b_f[:, None, None, :]
    state = cache["state"] * decay[..., None, None] + dbx
    y = (state @ c_in[:, 0, None, :, None].float())[..., 0]    # (B,H,P)
    y = y.to(x.dtype) + xs * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(bsz, 1, d_inner)
    return _gate_out(p, cfg, x, y, z), {"state": state, "conv": conv_state}
