"""RG-LRU recurrent block (Griffin, arXiv:2402.19427; RecurrentGemma).

The port of the JAX package's ``models/rglru.py``.  The block is

    x → [linear branch: GeLU(W_gate x)]
      → [recurrence branch: conv1d(W_x x) → RG-LRU]
    merged by elementwise product → W_out.

RG-LRU recurrence (per channel), gates and state in f32:

    r_t = σ(W_r x_t),  i_t = σ(W_i x_t)
    a_t = exp(−c · r_t · softplus(Λ)),  c = 8
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The reference scans the linear recurrence with ``associative_scan``; the
port composes the same pairs ``(a, b)`` by doubling (⌈log2 S⌉ steps of
tensor ops, no loop over S).  Decode is the one-step recurrence with an
O(1) state.
"""

from __future__ import annotations

import torch

from .layers import Params, gelu, shard_act, softplus

_C = 8.0


def rglru_spec(cfg, dtype) -> dict:
    """name → (shape, dtype, init scale, logical axes), the reference's
    ``init_rglru``: ``conv_b`` and ``lam`` stay f32 in a bf16 model."""
    w, d = cfg.lru_width or cfg.d_model, cfg.d_model
    return {
        "w_x": ((d, w), dtype, "fan_in", ("embed", "mlp")),
        "w_gate": ((d, w), dtype, "fan_in", ("embed", "mlp")),
        "conv_w": ((cfg.conv_width, w), dtype, 0.5, ("conv", "mlp")),
        "conv_b": ((w,), torch.float32, "zeros", ("mlp",)),
        "w_r": ((w, w), dtype, "fan_in", ("mlp", "mlp2")),
        "w_i": ((w, w), dtype, "fan_in", ("mlp", "mlp2")),
        # Λ so that a ∈ (0.9, 0.999) at r = 1 (Griffin appendix)
        "lam": ((w,), torch.float32, 1.0, ("mlp",)),
        "w_out": ((w, d), dtype, "fan_in", ("mlp", "embed")),
    }


def init_rglru(generator, cfg, dtype, device) -> Params:
    p = Params(rglru_spec(cfg, dtype), device)
    p.init(generator)
    return p


def _conv(cfg, p, x: torch.Tensor, conv_state: torch.Tensor | None = None):
    """Causal depthwise conv1d of width ``cfg.conv_width`` (no activation);
    ``conv_state``: the (B, W−1, C) history.  → (out, new history)."""
    w = cfg.conv_width
    if conv_state is None:
        # a zero history, joined by a cat: on a 2-d mesh torch 2.11's
        # DTensor gives F.pad's output a single placement
        conv_state = torch.zeros((x.shape[0], w - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xin = torch.cat([conv_state, x], dim=1)
    out = sum(xin[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(w))
    return (out + p["conv_b"]).to(x.dtype), xin[:, -(w - 1):]


def _gates(p, x: torch.Tensor):
    """(a, gated input), both f32; ``x`` is the conv'd recurrence branch."""
    r = torch.sigmoid((x @ p["w_r"]).float())
    i = torch.sigmoid((x @ p["w_i"]).float())
    log_a = -_C * r * softplus(p["lam"].float())
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t−1} + b_t`` along dim 1 from ``h_{−1} = 0``: the
    pairs compose as ``(a_l, b_l) ∘ (a_r, b_r) = (a_l a_r, b_l a_r + b_r)``,
    each step joining every prefix with the one ``d`` before it."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_scan(p, x: torch.Tensor) -> torch.Tensor:
    """(B,S,W) → (B,S,W) f32 states."""
    return linear_scan(*_gates(p, x))


def rglru_block(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Full recurrent block, training path."""
    gate = gelu(x @ p["w_gate"])
    rec, _ = _conv(cfg, p, x @ p["w_x"])
    h = shard_act(rglru_scan(p, rec).to(x.dtype), ("batch", "seq", "mlp"))
    return (h * gate) @ p["w_out"]


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_prefill(p, cfg, x: torch.Tensor, cache):
    gate = gelu(x @ p["w_gate"])
    rec, conv_state = _conv(cfg, p, x @ p["w_x"])
    h = rglru_scan(p, rec)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h[:, -1], "conv": conv_state}


def rglru_decode(p, cfg, x: torch.Tensor, cache):
    gate = gelu(x @ p["w_gate"])
    rec, conv_state = _conv(cfg, p, x @ p["w_x"], cache["conv"])
    a, b = _gates(p, rec)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None].to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}
