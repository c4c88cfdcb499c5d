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

The reference's ``param_shardings`` (grads pinned to their params' mesh
shardings) has no counterpart until the launcher's mesh is ported
(ROADMAP §1 item 3): the port trains on one device.
"""

from __future__ import annotations

import time

import torch

from .optimizer import OptConfig, apply_updates, init_opt_state


def _split_batch(batch: dict, n: int) -> list:
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by {n} microbatches")
        return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]
    parts = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_loss_and_grads(model, microbatches: int = 1):
    """batch → (loss, metrics, grads), grads a list in
    ``named_parameters()`` order: the params' dtype for one microbatch,
    f32 accumulators (each microbatch's grad ÷ n, summed) for several."""

    def single(batch):
        params = list(model.parameters())
        for p in params:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            [p.grad for p in params]

    if microbatches == 1:
        return single

    def accumulated(batch):
        params = list(model.parameters())
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
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


def make_train_step(model, opt_cfg: OptConfig, *, microbatches: int = 1):
    """→ ``train_step(opt_state, batch) → (opt_state, metrics)``.

    Besides the model's (``loss``, ``ce``, ``aux``) and the optimizer's
    (``grad_norm``, ``lr``) metrics, ``opt_s`` is the optimizer's host
    seconds, the device synchronized before and after it."""
    loss_and_grads = make_loss_and_grads(model, microbatches)

    def train_step(opt_state, batch):
        params = list(model.parameters())
        device = params[0].device
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
