"""Carry the JAX package's parameters into a port model.

The reference keeps its parameters as a nested dict.  A decoder LM's
holds ``embedding``, ``final_norm``, ``prefix`` (DeepSeek's leading dense
layers, one dict each), ``groups`` (each leaf stacked over the repeated
layer groups on a leading axis), ``tail`` (the layers past the last
whole group, e.g. recurrentgemma's two RG-LRU layers) and ``mtp``
(DeepSeek-V3's multi-token-prediction head); an
encoder-decoder's holds ``embedding``, ``enc`` and ``dec`` (each leaf
stacked over that stack's layers) and ``enc_norm``/``dec_norm``.  The
caller hands that tree over as numpy arrays — e.g.
``jax.tree.map(np.asarray, params)`` — so this module needs neither JAX
nor the reference; it slices the group axis per layer and loads each
leaf into the matching parameter of the model, on the model's
device and in its dtype.  The optimizer's moments and master copies have
the params' tree structure and travel the same way
(:func:`load_reference_opt_state`); :func:`reference_tree` is the
inverse, port → reference layout, which checkpoints are written in.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.optimizer import OptState
from .transformer import stack_plan


def _tensor(a) -> torch.Tensor:
    """numpy → torch; bfloat16 arrays (numpy's ``ml_dtypes`` type) travel
    as their 16-bit patterns.  A tensor passes through."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:            # a JAX array's read-only view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree, prefix: str, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v
    return out


# an encoder-decoder's stacks: tree key → the model's ModuleList
STACKS = ("enc", "dec")


def _stacked_state(model, tree) -> dict:
    """An encoder-decoder's tree, each stack's layer axis sliced away."""
    flat = {k: v for k, v in tree.items() if k not in STACKS}
    for stack in STACKS:
        n = len(getattr(model, stack))
        for k, v in _flatten(tree[stack], "", {}).items():
            if v.shape[0] != n:
                raise ValueError(f"{stack}.{k}: {v.shape[0]} layers; "
                                 f"{model.cfg.name} has {n}")
            flat.update({f"{stack}.{i}.{k}": v[i] for i in range(n)})
    return flat


def reference_state(model, tree) -> dict:
    """The reference param ``tree`` as a flat ``{state_dict key: array}``
    for ``model`` (one entry per layer, the group or stack axis sliced
    away; a decoder's dense ``prefix`` layers first, then its groups and
    tail, then the ``mtp`` head's leaves)."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        return _stacked_state(model, tree)
    prefix, group_kinds, n_groups, tail_kinds = stack_plan(cfg)
    n_prefix, glen = len(prefix), len(group_kinds)
    n_grouped = n_groups * glen
    groups = {leaf.shape[0] for leaf in
              _flatten(tree.get("groups", {}), "", {}).values()}
    tail = len(tree.get("tail", {}))
    if (groups - {n_groups} or tail != len(tail_kinds) or
            len(tree.get("prefix", {})) != n_prefix or
            ("mtp" in tree) != bool(cfg.mtp_depth)):
        raise ValueError(
            f"the tree holds {len(tree.get('prefix', {}))} prefix layers, "
            f"{sorted(groups)} layer groups, {tail} tail layers and "
            f"{'an' if 'mtp' in tree else 'no'} MTP head; {cfg.name} has "
            f"{n_prefix}, {n_groups}, {len(tail_kinds)} and "
            f"{'one' if cfg.mtp_depth else 'none'}")
    flat = {"embedding": tree["embedding"], "final_norm": tree["final_norm"]}
    for layer in range(len(model.blocks)):
        at = layer - n_prefix
        if layer < n_prefix:
            block = _flatten(tree["prefix"][f"block{layer}"], "", {})
        elif at < n_grouped:
            g, i = divmod(at, glen)
            block = _flatten(tree["groups"][f"block{i}"], "", {})
            block = {k: v[g] for k, v in block.items()}
        else:
            block = _flatten(tree["tail"][f"block{at - n_grouped}"], "", {})
        flat.update({f"blocks.{layer}.{k}": v for k, v in block.items()})
    if cfg.mtp_depth:
        flat.update(_flatten(tree["mtp"], "mtp.", {}))
    return flat


@torch.no_grad()
def load_reference_params(model, tree):
    """Load the reference param ``tree`` (numpy leaves) into ``model``;
    every parameter must be covered, with its shape.  Returns the model."""
    own = dict(model.named_parameters())
    flat = reference_state(model, tree)
    if set(flat) != set(own):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(own) - set(flat))}, unexpected "
                         f"{sorted(set(flat) - set(own))}")
    for name, arr in flat.items():
        p = own[name]
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, model "
                             f"{tuple(p.shape)}")
        p.copy_(t.to(device=p.device, dtype=p.dtype))
    return model


def _put(tree: dict, keys, value) -> None:
    *path, leaf = keys
    for k in path:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def reference_tree(model, values) -> dict:
    """The inverse of :func:`reference_state`: ``values``, one tensor per
    parameter of ``model`` in ``named_parameters()`` order, as the
    reference's nested tree (each group leaf stacked on a leading axis),
    leaves as tensors on the values' device in their own dtypes (bf16
    stays bf16, which numpy cannot hold without ``ml_dtypes``)."""
    cfg = model.cfg
    if not cfg.is_encoder_decoder:
        prefix, group_kinds, n_groups, _ = stack_plan(cfg)
        n_prefix, glen = len(prefix), len(group_kinds)
        n_grouped = n_groups * glen
    names = [n for n, _ in model.named_parameters()]
    values = list(values)
    if len(values) != len(names):
        raise ValueError(f"{len(values)} values for {len(names)} parameters")
    tree: dict = {}
    stacks: dict = {}               # (path in the tree) → per-layer values
    for name, v in zip(names, values):
        head, _, rest = name.partition(".")
        if head in STACKS and cfg.is_encoder_decoder:
            sub = rest.partition(".")[2]           # past the layer index
            stacks.setdefault((head, *sub.split(".")), []).append(v.detach())
        elif head != "blocks":
            _put(tree, name.split("."), v.detach())
        else:
            layer, _, sub = rest.partition(".")
            at = int(layer) - n_prefix
            if at < 0:
                _put(tree, ["prefix", f"block{layer}", *sub.split(".")],
                     v.detach())
            elif at < n_grouped:     # layers come in order: group g at g
                stacks.setdefault(("groups", f"block{at % glen}",
                                   *sub.split(".")), []).append(v.detach())
            else:
                _put(tree, ["tail", f"block{at - n_grouped}",
                            *sub.split(".")], v.detach())
    for path, per_layer in stacks.items():
        _put(tree, path, torch.stack(per_layer))
    return tree


def reference_opt_tree(model, opt) -> tuple:
    """An :class:`~repro_torch.train.optimizer.OptState` of ``model`` as
    the reference's ``OptState(step, mu, nu, master)`` fields (a plain
    tuple; ``master`` is ``()`` in low-memory mode)."""
    return (opt.step.detach(), reference_tree(model, opt.mu),
            reference_tree(model, opt.nu),
            reference_tree(model, opt.master) if len(opt.master) else ())


def load_reference_opt_state(model, opt_tree, device=None):
    """The reference's ``OptState(step, mu, nu, master)`` (numpy or tensor
    leaves, the params' tree structure) as the port's ``OptState`` for
    ``model``, on ``device`` (default: the model's), each leaf in its own
    dtype."""
    device = model.device if device is None else torch.device(device)
    names = [n for n, _ in model.named_parameters()]
    step, mu, nu, master = opt_tree

    def per_param(tree):
        flat = reference_state(model, tree)
        if set(flat) != set(names):
            raise ValueError("optimizer tree does not cover the parameters")
        return [_tensor(flat[n]).to(device).clone() for n in names]

    return OptState(
        torch.tensor(int(step), dtype=torch.int32, device=device),
        per_param(mu), per_param(nu),
        per_param(master) if len(master) else ())
