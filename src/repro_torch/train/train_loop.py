"""Train-step factory: microbatch gradient accumulation + remat + AdamW.

The port of the JAX package's ``train/train_loop.py``.
``make_train_step(model, opt_cfg, microbatches=n)`` returns

    train_step(opt_state, batch) → (opt_state, metrics)

which updates ``model``'s parameters in place.  With ``microbatches > 1``
the global batch splits along axis 0 and the grads accumulate in f32,
one microbatch at a time (the reference's ``lax.scan``): activation
memory drops by the microbatch factor, param and optimizer memory do
not.  The model's own remat policy (``cfg.remat``: each block recomputed
in the backward pass) handles the within-layer recompute.

On a mesh the model's parameters are DTensors
(``launch.sharding.distribute_params``) and the step is the same code:
``place_batch`` makes each microbatch DTensors (``distribute_batch``),
the step runs under ``implicit_replication`` (plain tensors made inside
the model, such as positions and masks, count as replicated), and each
gradient is brought to its parameter's placements before the update
(the reference's ``param_shardings``), so the optimizer state keeps
them.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from .optimizer import OptConfig, apply_updates, init_opt_state


def _split_batch(batch: dict, n: int) -> list:
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]
    parts = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def sharded(model) -> bool:
    """Whether ``model``'s parameters are DTensors (on a mesh)."""
    return isinstance(next(model.parameters()), DTensor)


def replication(model):
    """``implicit_replication`` for a model on a mesh, else nothing."""
    return implicit_replication() if sharded(model) else \
        contextlib.nullcontext()


def _pinned(p, g):
    """A DTensor gradient redistributed to its parameter's placements."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_loss_and_grads(model, microbatches: int = 1, place_batch=None):
    """batch → (loss, metrics, grads), grads a list in
    ``named_parameters()`` order: the params' dtype for one microbatch,
    f32 accumulators (each microbatch's grad ÷ n, summed) for several.
    ``place_batch`` (optional) maps each microbatch before the model
    reads it."""

    def single(batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        if place_batch is not None:
            batch = place_batch(batch)
        loss, metrics = model.loss(batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            [_pinned(p, p.grad) for p in params]

    if microbatches == 1:
        return single

    def accumulated(batch):
        params = list(model.parameters())
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        lsum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        per = []
        for mb in _split_batch(batch, microbatches):
            loss, metrics, grads = single(mb)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.float() / microbatches)
            lsum = lsum + loss / microbatches
            per.append(metrics)
        for p in params:
            p.grad = None
        metrics = {k: torch.stack([m[k] for m in per]).mean()
                   for k in per[0]}
        return lsum, metrics, acc

    return accumulated


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1,
                    place_batch=None):
    """→ ``train_step(opt_state, batch) → (opt_state, metrics)``.

    Besides the model's (``loss``, ``ce``, ``aux``) and the optimizer's
    (``grad_norm``, ``lr``) metrics, ``opt_s`` is the optimizer's host
    seconds, the device synchronized before and after it.
    ``place_batch``: see :func:`make_loss_and_grads` (a mesh's
    ``distribute_batch``)."""
    loss_and_grads = make_loss_and_grads(model, microbatches, place_batch)

    def train_step(opt_state, batch):
        params = list(model.parameters())
        device = params[0].device
        with replication(model):
            loss, metrics, grads = loss_and_grads(batch)
            _sync(device)
            t0 = time.perf_counter()
            opt_state, opt_metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        _sync(device)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["opt_s"] = time.perf_counter() - t0
        return opt_state, metrics

    return train_step


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: OptConfig | None = None):
    """Random init of ``model`` from ``generator`` (a generator on its
    device), then a fresh optimizer state → (model, opt_state).  (The
    reference returns (params, axes, opt_state).)"""
    opt_cfg = OptConfig() if opt_cfg is None else opt_cfg
    model.init(generator)
    return model, init_opt_state(model.parameters(), opt_cfg)
