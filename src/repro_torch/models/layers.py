"""Shared model components: init, norms, RoPE, MLPs, embedding, LM head.

The port of the JAX package's ``models/layers.py``.  Parameters are
``nn.Parameter`` tensors owned by ``nn.Module`` blocks (see
:mod:`.transformer`); the functions here are plain functions on tensors.

Rounding follows the reference op for op, so a bf16 model computes what
the JAX one computes: reductions and RoPE angles in f32, products and
outputs in the compute dtype.  Scalars that the reference folds into a
bf16 product (``1 + weight``, the embedding scale) are rounded to the
compute dtype first, as JAX's weak typing does.

Every parameter carries the reference's *logical* sharding axes as
``.axes`` (a tuple, one name or ``None`` per dim: ``param``'s ``axes``,
the fourth field of a ``Params`` spec, ``init_rms``'s ``axes``); the
launcher maps them onto a mesh (``launch/sharding.py``), so models never
name a mesh axis.  :func:`shard_act` annotates an activation with its
logical axes; it is the identity unless the launcher installs a rule
(:func:`set_activation_rule`).  The few ops whose plain form a sharded
tensor refuses (:func:`mesh_op`: cache writes, head splits, the LM
head's pad fill, the MoE's routing gather and its expert dispatch and
combine) are plain here; the launcher installs its mesh's
versions with the rule, so no model code knows of a mesh.
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -2.0e38        # masked logit / score value, as in the reference
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def remat_call(cfg, blk, *args):
    """``blk(*args)``; with ``cfg.remat`` and autograd recording, its
    activations are recomputed in the backward pass (the reference's
    ``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(blk, *args, use_reentrant=False)
    return blk(*args)


def with_axes(p: torch.nn.Parameter, axes) -> torch.nn.Parameter:
    """``p`` with its logical axes recorded as ``p.axes``."""
    if axes is not None:
        axes = tuple(axes)
        if len(axes) != p.dim():
            raise ValueError(f"axes {axes} for a {p.dim()}-d parameter")
        p.axes = axes
    return p


def axes_of(p: torch.Tensor, name: str = "") -> tuple:
    """A parameter's logical axes (every parameter of the zoo has them)."""
    axes = getattr(p, "axes", None)
    if axes is None:
        raise ValueError(f"parameter {name or tuple(p.shape)} has no "
                         f"logical axes")
    return axes


def empty(shape, axes, dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter with its logical axes."""
    return with_axes(torch.nn.Parameter(torch.empty(
        shape, dtype=dtype, device=device)), axes)


def param(generator: torch.Generator, shape, axes=None, *,
          dtype=torch.float32, device="cuda",
          scale: float | str = "fan_in") -> torch.nn.Parameter:
    """A parameter with truncated-normal init (or zeros/ones), carrying
    the logical ``axes`` when given.

    Drawn in f32 on ``device`` from ``generator`` (a generator on that
    device), scaled, then cast to ``dtype``: the reference's ``param``.
    ``"fan_in"`` scales by 1/sqrt(shape[-2]) (shape[-1] for vectors)."""
    if scale == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif scale == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    else:
        if scale == "fan_in":
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(fan)
        v = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        v = v.mul_(scale).to(dtype)
    return with_axes(torch.nn.Parameter(v), axes)


def redraw(generator, w: torch.nn.Parameter,
           scale: float | str = "fan_in") -> torch.nn.Parameter:
    """A fresh :func:`param` of ``w``'s shape, dtype, device and axes."""
    return param(generator, tuple(w.shape), getattr(w, "axes", None),
                 dtype=w.dtype, device=w.device, scale=scale)


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


class Params(torch.nn.Module):
    """A mixer's parameters under the reference's names, read as
    ``p["name"]`` like the reference's dict: ``spec`` maps each name to
    ``(shape, dtype, scale, axes)``, ``scale`` as :func:`param` takes it
    and ``axes`` the reference's logical axes, or to a nested spec (a
    sub-dict of the reference's, e.g. the MoE's ``shared`` expert), which
    becomes a child ``Params``.  Construction allocates them
    uninitialised; :meth:`init` draws them."""

    def __init__(self, spec: dict, device):
        super().__init__()
        self.scales = {name: s[2] for name, s in spec.items()
                       if not isinstance(s, dict)}
        for name, s in spec.items():
            if isinstance(s, dict):
                self.add_module(name, Params(s, device))
            else:
                shape, dtype, _, axes = s
                self.register_parameter(name, empty(shape, axes, dtype,
                                                    device))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def init(self, generator) -> None:
        for name, scale in self.scales.items():
            setattr(self, name, redraw(generator, getattr(self, name),
                                       scale))
        for child in self.children():
            child.init(generator)


# ---------------------------------------------------------------------------
# Activation sharding constraints and the ops a mesh changes (logical →
# physical happens in launch/)
# ---------------------------------------------------------------------------

_ACT_RULE: Callable | None = None
_MESH_OPS: dict = {}


def set_activation_rule(fn, **ops) -> None:
    """Install the logical→physical activation-sharding hook (launcher
    only), and with it a mesh's own versions of the :func:`mesh_op`
    functions below, by name; ``None`` removes them all."""
    global _ACT_RULE, _MESH_OPS
    _ACT_RULE = fn
    _MESH_OPS = dict(ops) if fn is not None else {}


def shard_act(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Annotate an activation with logical axes (no-op without a launcher)."""
    if _ACT_RULE is None:
        return x
    return _ACT_RULE(x, axes)


def mesh_op(fn):
    """``fn``, the op on plain tensors, unless the launcher installed a
    mesh's version under its name (:func:`set_activation_rule`)."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(*args):
        return _MESH_OPS.get(name, fn)(*args)
    return call


@mesh_op
def write_seq(dst: torch.Tensor, start: int, src: torch.Tensor) -> None:
    """``dst[:, start:start + n] = src`` in place (a cache write along the
    sequence dim)."""
    dst[:, start:start + src.shape[1]] = src


@mesh_op
def split_dim(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``."""
    return x.unflatten(dim, sizes)


@mesh_op
def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim, dim + 1)``."""
    return x.flatten(dim, dim + 1)


@mesh_op
def whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a plain tensor, whole on every rank (the MoE routing's
    small int data, which every rank needs whole)."""
    return x


@mesh_op
def fill_from(x: torch.Tensor, start: int, value: float) -> torch.Tensor:
    """``x`` with ``x[..., start:] = value`` (in place)."""
    x[..., start:] = value
    return x


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's hand-written VJP (the fused-layernorm
    backward): reductions in f32, while the (…, D) output and its
    cotangent stay in the compute dtype.  Autograd over the forward would
    route part of the gradient through the f32 variance branch and round
    differently."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        var = x.float().square().mean(-1, keepdim=True)
        s32 = torch.rsqrt(var + eps)                       # (…, 1) f32
        ctx.save_for_backward(x, s32, weight)
        return x * s32.to(x.dtype) * (1.0 + weight.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, s32, weight = ctx.saved_tensors
        xf = x.float()
        gw = g.float() * (1.0 + weight.float())
        d = x.shape[-1]
        # dx = s·gw − x·s³·mean(gw·x)
        m = (gw * xf).sum(-1, keepdim=True) / d
        dx = s32 * gw - xf * (s32 * s32 * s32) * m
        dw = (g.float() * xf * s32).reshape(-1, d).sum(0)
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: variance in f32, output in ``x``'s dtype; ``weight`` is
    stored as (scale − 1), so a zero init is the identity (``init_rms``).
    Differentiable in ``x`` and ``weight`` through the reference's
    hand-written VJP (``_RMSNorm``); ``eps`` is not."""
    return _RMSNorm.apply(x, weight, eps)


def init_rms(dim: int, device, axes=("embed",)) -> torch.nn.Parameter:
    """(weight − 1) storage, zeros → identity norm (f32, as the reference)."""
    return with_axes(torch.nn.Parameter(torch.zeros(
        dim, dtype=torch.float32, device=device)), axes)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``softplus``: ``logaddexp(x, 0)`` (``F.softplus`` returns x
    itself above its threshold of 20, which differs)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Rotary position embeddings (NeoX half-rotation)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) — rotate pairs (d, d+D/2).

    Angles in f32; the rotation in ``x``'s dtype (sin and cos are cast
    first), as the reference keeps it for bf16."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(d, theta).astype(np.float32),
                            device=x.device)
    ang = positions.float()[..., None] * freqs              # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)           # (..., S, 1, D/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(-math.log(10000.0) * np.arange(0, dim, 2) / dim)
    enc = np.zeros((length, dim), np.float32)
    enc[:, 0::2] = np.sin(pos * div)
    enc[:, 1::2] = np.cos(pos * div)
    return enc


# ---------------------------------------------------------------------------
# MLPs (``p`` holds the weights under the reference's names)
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int, dtype, names=("gate", "up",
                                                     "down")) -> dict:
    """A SwiGLU (``gate``/``up``/``down``) or GELU (``up``/``down``) MLP's
    ``Params`` spec, fan-in init, under the reference's logical axes."""
    shapes = {"gate": ((d_model, d_ff), ("embed", "mlp")),
              "up": ((d_model, d_ff), ("embed", "mlp")),
              "down": ((d_ff, d_model), ("mlp", "embed"))}
    return {n: (shapes[n][0], dtype, "fan_in", shapes[n][1]) for n in names}


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    h = silu(x @ p["gate"]) * (x @ p["up"])
    h = shard_act(h, ("batch", "seq", "mlp"))
    return h @ p["down"]


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = gelu(x @ p["up"])
    h = shard_act(h, ("batch", "seq", "mlp"))
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed(p_emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return shard_act(p_emb[tokens], ("batch", "seq", "embed"))


def logits_from_tied(p_emb: torch.Tensor, h: torch.Tensor,
                     valid_vocab: int = 0) -> torch.Tensor:
    """LM head against the (possibly pad-extended) embedding rows.
    Columns ≥ ``valid_vocab`` (the padding that made the vocab
    16-divisible) are set to −2.0e38 in the logits' dtype, so softmax and
    argmax never pick them."""
    out = shard_act(h @ p_emb.T, ("batch", "seq", "vocab"))
    if valid_vocab and valid_vocab < p_emb.shape[0]:
        out = fill_from(out, valid_vocab, NEG_INF)
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < 0 are ignored."""
    logits = logits.float()
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    ll = torch.where(valid, ll, torch.zeros_like(ll))
    denom = valid.sum().clamp(min=1)
    return -ll.sum() / denom
