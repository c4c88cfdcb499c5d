"""AdamW with global-norm clipping and a cosine schedule, on plain tensors.

The port of the JAX package's ``train/optimizer.py``.  Mixed-precision
policy: model params live in bf16; the optimizer keeps fp32 first and
second moments **and an fp32 master copy** of the params, consumes bf16
(or f32 accumulated) grads, and writes fresh params in each param's own
dtype.  Low-memory mode (``use_master=False``, ``moments_dtype=
"bfloat16"``) keeps bf16 moments and updates the bf16 params themselves.

The state is a list per quantity, one tensor per parameter in the model's
``named_parameters()`` order.  The arithmetic is the reference's, op for
op, in f32 (``torch.optim.AdamW`` applies its decay before the step, has
no clip and no master copy, and rounds differently).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # Memory policy.  Default: fp32 moments + fp32 master weights
    # (14 B/param with bf16 params).  Low-mem mode: bf16 moments, no
    # master (6 B/param).
    moments_dtype: str = "float32"
    use_master: bool = True


class OptState(NamedTuple):
    step: torch.Tensor         # () int32
    mu: list                   # moments_dtype, one per param
    nu: list                   # moments_dtype, one per param
    master: list | tuple       # fp32 master weights (or () in low-mem mode)


def init_opt_state(params, cfg: OptConfig | None = None) -> OptState:
    """Zero moments and (master mode) an f32 copy of each of ``params``,
    on each param's device; the step counter on the first param's."""
    cfg = OptConfig() if cfg is None else cfg
    params = list(params)
    mdt = _DTYPES[cfg.moments_dtype]
    mu = [torch.zeros_like(p, dtype=mdt) for p in params]
    nu = [torch.zeros_like(m) for m in mu]
    master = ([p.detach().float().clone() for p in params]
              if cfg.use_master else ())
    step = torch.zeros((), dtype=torch.int32, device=params[0].device)
    return OptState(step, mu, nu, master)


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; f32, as the
    reference computes it from its int32 step."""
    step = step.float()
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tensors))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState):
    """One AdamW step.  ``params`` and ``grads`` are same-length lists in
    ``named_parameters()`` order; the params, moments and master copies
    are updated in place.  → (new_state, metrics ``grad_norm``, ``lr``)."""
    params, grads = list(params), list(grads)
    step = state.step + 1
    gnorm = global_norm(grads)
    # a true division (``scalar / tensor`` multiplies by a reciprocal)
    scale = torch.clamp(torch.div(gnorm.new_tensor(cfg.clip_norm),
                                  torch.clamp(gnorm, min=1e-9)), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = lr_at(cfg, step)

    refs = state.master if cfg.use_master else params
    for p, g, mu, nu, ref in zip(params, grads, state.mu, state.nu, refs):
        # ref: the fp32 master (master mode) or the bf16 param (low-mem)
        g = g.float() * scale
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * g.square()
        update = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        w = ref.float()
        w = w - lr * (update + cfg.weight_decay * w)
        mu.copy_(mu32)
        nu.copy_(nu32)
        if cfg.use_master:
            ref.copy_(w)
        p.copy_(w)
    return (OptState(step, state.mu, state.nu, state.master),
            {"grad_norm": gnorm, "lr": lr})
