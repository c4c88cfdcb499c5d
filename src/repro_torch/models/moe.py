"""Mixture-of-Experts FFN (DeepSeek-style: shared + fine-grained routed).

The port of the JAX package's ``models/moe.py``, line for line.  Routing
is a float32 softmax over the router's logits, top-k renormalised, with
the Switch load-balancing auxiliary loss.  Dispatch is the sort-based
capacity scheme: the (token, expert) assignments are stably sorted by
expert id, each gets its rank in its expert's queue, and ranks at or past
the capacity drop (the residual passes the token on unchanged).  The
kept rows fill ``(E, C, d)`` buffers, the routed SwiGLU experts run as
three batched GEMMs over all experts, and the outputs return to their
tokens weighted by their router probabilities.

The capacity is reckoned per call, ``max(int(capacity_factor·T·k/E),
1)`` over the call's T tokens, as the reference reckons it: a token's
output depends on how many tokens share the call (ROADMAP §3), and a
decode step of 8 sequences at full width gets C = 1.

Rounding the reference fixes and the port keeps:

* **Top-k ties.**  ``jax.lax.top_k`` returns the lower expert index
  first among equal probabilities; a stable descending sort does too
  (``torch.topk``'s tie order is unspecified).
* **The combine.**  The reference scatter-adds each token's k weighted
  contributions into zeros in the compute dtype, in the order of the
  sorted assignments (ascending expert id per token).  The port gathers
  them in that order and sums left to right in the compute dtype, which
  is the same rounding on every device (``index_add_`` on CUDA adds with
  atomics, in no fixed order).
* **Dropped rows** gather ``out_buf[e, C−1]`` times a zero weight, as
  the reference does, rather than being masked out.

On a mesh the routing stays global: every rank computes the same plan
(:class:`Routing`) from the expert ids of the whole call, gathered across
the token-sharded ranks (:func:`~.layers.whole`), so the capacity and the
drops are one device's.  The two data moves, :func:`expert_buffers` and
:func:`expert_combine`, are :func:`~.layers.mesh_op` ops: the launcher's
versions (``launch/sharding.py``) fill each rank's own experts' slice of
the buffers and bring the expert outputs back to the token-sharded ranks
(expert parallelism, the reference's GSPMD all-to-all).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .layers import (Params, merge_dims, mesh_op, mlp_spec, shard_act, silu,
                     split_dim, whole)


def moe_spec(cfg, dtype) -> dict:
    """name → (shape, dtype, init scale, logical axes), the reference's
    ``init_moe``:
    the router ``(d, E)`` in float32, the routed experts stacked on a
    leading E axis, and ``shared`` (width ``moe_d_ff`` × the shared
    expert count) when the config has shared experts."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    spec = {"router": ((d, e), torch.float32, "fan_in",
                       ("embed", "experts")),
            "gate": ((e, d, ff), dtype, "fan_in",
                     ("experts", "embed", "expert_mlp")),
            "up": ((e, d, ff), dtype, "fan_in",
                   ("experts", "embed", "expert_mlp")),
            "down": ((e, ff, d), dtype, "fan_in",
                     ("experts", "expert_mlp", "embed"))}
    if cfg.num_shared_experts:
        spec["shared"] = mlp_spec(d, ff * cfg.num_shared_experts, dtype)
    return spec


def init_moe(generator, cfg, dtype, device) -> Params:
    p = Params(moe_spec(cfg, dtype), device)
    p.init(generator)
    return p


def router_probs(p, x: torch.Tensor) -> torch.Tensor:
    """(…, d) activations → (…, E) float32 router probabilities: the
    logits in float32 (``x`` cast first), then a softmax over experts."""
    return torch.softmax(x.float() @ p["router"], dim=-1)


def top_k(probs: torch.Tensor, k: int):
    """(weights, expert ids) of the ``k`` largest probabilities per row,
    largest first, the lower id first among equal ones (``jax.lax.top_k``'s
    order): a stable descending sort."""
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], ids[..., :k]


def capacity(cfg, tokens: int) -> int:
    """Rows per expert buffer for a call over ``tokens`` tokens."""
    return max(int(cfg.capacity_factor * tokens * cfg.top_k /
                   cfg.num_experts), 1)


def combine(contrib: torch.Tensor, order: torch.Tensor, k: int):
    """The reference's ``zeros((T, d)).at[st_].add(contrib)``: ``contrib``
    (T·k, d) holds the weighted expert outputs in sorted order (row ``j``
    is assignment ``order[j]``, of token ``order[j] // k``).  Each token's
    k rows are gathered in sorted order and summed left to right in
    ``contrib``'s dtype: the order, and so the rounding, of the
    reference's scatter-add."""
    tk, d = contrib.shape
    sorted_pos = torch.empty_like(order)
    sorted_pos[order] = torch.arange(tk, device=order.device)
    mine = contrib[sorted_pos.view(tk // k, k).sort(dim=-1).values]
    yf = mine[:, 0]
    for i in range(1, k):
        yf = yf + mine[:, i]
    return yf


class Routing(NamedTuple):
    """The sort-based dispatch plan of one call, over its T·k assignments
    in expert-sorted order (plain tensors, the same on every rank):
    ``order`` (assignment ids: token·k + choice), ``se`` and ``st`` (their
    expert and token), ``slot`` (the row in the expert's buffer) and
    ``keep`` (within capacity); ``e`` experts, ``c`` rows each, top-``k``."""
    order: torch.Tensor
    se: torch.Tensor
    st: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    e: int
    c: int
    k: int


def plan(flat_e: torch.Tensor, counts: torch.Tensor, c: int,
         k: int) -> Routing:
    """The sort-based dispatch plan of a call's (T·k,) expert ids, with
    ``counts`` per expert and ``c`` rows each."""
    n, dev = flat_e.shape[0], flat_e.device
    flat_t = torch.arange(n, device=dev) // k
    order = torch.argsort(flat_e, stable=True)
    se, st_ = flat_e[order], flat_t[order]
    # rank within expert queue = position − start offset of that expert
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[se]
    keep = rank < c
    slot = torch.where(keep, rank, c - 1)
    return Routing(order, se, st_, slot, keep, counts.shape[0], c, k)


@mesh_op
def expert_buffers(xf: torch.Tensor, route: Routing) -> torch.Tensor:
    """(T, d) token rows → the (E, C, d) expert buffers: each kept row has
    a slot of its own; a dropped row adds zeros to its expert's last
    slot."""
    rows = torch.where(route.keep[:, None], xf[route.st],
                       torch.zeros((), dtype=xf.dtype, device=xf.device))
    rows = shard_act(rows, ("tokens", "embed"))
    buf = torch.zeros((route.e, route.c, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf.index_put_((route.se, route.slot), rows, accumulate=True)
    return buf


@mesh_op
def expert_combine(out_buf: torch.Tensor, topw: torch.Tensor,
                   route: Routing) -> torch.Tensor:
    """The (E, C, d) expert outputs → (T, d): each kept row's output back
    at its token, weighted by its router probability (``topw``, (T, k)),
    the token's k rows summed by :func:`combine`."""
    sw = topw.reshape(-1)[route.order]
    weight = torch.where(route.keep, sw,
                         torch.zeros((), device=sw.device))
    contrib = shard_act(out_buf[route.se, route.slot] *
                        weight[:, None].to(out_buf.dtype),
                        ("tokens", "embed"))
    return combine(contrib, route.order, route.k)


def moe_ffn(p, cfg, x: torch.Tensor):
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar float32)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    t = b * s
    xf = merge_dims(x, 0)                                    # (T, d)

    probs = router_probs(p, xf)                              # (T, E)
    topw, tope = top_k(probs, k)                             # (T, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux (Switch): E * Σ_e fraction_tokens_e · mean_prob_e
    me = probs.mean(dim=0)
    flat_e = whole(tope).reshape(-1)                         # (T*k,)
    dev = flat_e.device
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (t * k)
    aux = cfg.router_aux_weight * e * torch.sum(me * ce)

    route = plan(flat_e, counts, capacity(cfg, t), k)

    # gather tokens into (E, C, d) expert buffers
    buf = shard_act(expert_buffers(xf, route), ("experts", None, "embed"))

    h = silu(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    h = shard_act(h, ("experts", None, "expert_mlp"))
    out_buf = torch.bmm(h, p["down"])                        # (E, C, d)
    out_buf = shard_act(out_buf, ("experts", None, "embed"))

    # combine back to tokens, weighted by router prob
    yf = shard_act(expert_combine(out_buf, topw, route), ("tokens", "embed"))

    if cfg.num_shared_experts:
        sp = p["shared"]
        sh = silu(xf @ sp["gate"]) * (xf @ sp["up"])
        yf = yf + sh @ sp["down"]
    # on a mesh the tokens may split where the batch does not
    return split_dim(shard_act(yf, ("tokens", "embed")), 0, (b, s)), aux
