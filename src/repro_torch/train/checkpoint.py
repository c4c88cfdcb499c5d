"""Atomic, resumable checkpoints in the JAX package's on-disk layout.

The port of the JAX package's ``train/checkpoint.py``.  Layout::

    <dir>/step_00000123.tmp/       ← written first
        manifest.json              (step, leaf count, structure, shapes,
                                    logical dtypes)
        leaf_00000.npy …           (one file per leaf; bf16 as uint16)
    <dir>/step_00000123/           ← atomic rename marks the commit
    <dir>/LATEST                   ← text file, updated after the rename

A state is a dict whose values are a model (its parameters) and an
:class:`~repro_torch.train.optimizer.OptState` of that model, e.g.
``{"params": model, "opt": opt_state}``.  Its leaves are written in the
reference's order and shapes — ``jax.tree.flatten`` of the same state in
the reference's layout: dict keys sorted, ``OptState(step, mu, nu,
master)`` fields in order, each layer group's leaves stacked on a leading
axis — so either package restores a checkpoint the other wrote.

Fault-tolerance contract (as the reference's):
  * a crash mid-write leaves only a ``.tmp`` dir → ignored on restore;
  * ``restore_latest`` returns the newest *committed* step;
  * ``keep`` bounds disk usage (old committed steps pruned after commit);
  * a leaf-count or shape mismatch raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..models import convert
from .optimizer import OptState


def _model_of(state: dict):
    models = [v for v in state.values() if isinstance(v, torch.nn.Module)]
    if len(models) != 1:
        raise ValueError("a checkpoint state holds exactly one model")
    return models[0]


def _reference_layout(state: dict, to) -> dict:
    """The state as the reference's tree, each tensor mapped by ``to``
    first (to the host to write it, to ``meta`` for shapes alone)."""
    model = _model_of(state)
    out = {}
    for key, v in state.items():
        if isinstance(v, torch.nn.Module):
            out[key] = convert.reference_tree(
                v, [to(p.detach()) for p in v.parameters()])
        elif isinstance(v, OptState):
            out[key] = convert.reference_opt_tree(model, OptState(
                to(v.step), [to(t) for t in v.mu], [to(t) for t in v.nu],
                [to(t) for t in v.master]))
        else:
            raise TypeError(f"{key}: cannot checkpoint a {type(v).__name__}")
    return out


def _leaves(tree) -> list:
    """``jax.tree.flatten``'s leaf order: dict keys sorted, tuples in
    order, ``()`` holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return tuple(_unflatten(t, leaves) for t in tree)
    return next(leaves)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(t) for t in tree) + ")"
    return "*"


def _to_numpy(t: torch.Tensor):
    """→ (array to write, logical dtype); numpy cannot hold bf16, so it
    travels as its 16-bit patterns."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _committed(ckpt_dir: str) -> list:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3) -> str:
    """Write one committed checkpoint; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    tree = _reference_layout(state, lambda t: t.cpu())
    leaves = _leaves(tree)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": f"PyTreeDef({_structure(tree)})",
        "leaves": [],
    }
    for i, leaf in enumerate(leaves):
        arr, logical_dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape),
                                   "dtype": logical_dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)            # the commit point
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))

    for old in _committed(ckpt_dir)[:-keep]:     # prune old committed steps
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        # LATEST points at a pruned/corrupt dir → fall back to newest on disk
        steps = _committed(ckpt_dir)
        if not steps:
            return None
        name = steps[-1]
    return int(name.split("_")[1])


def restore(ckpt_dir: str, step: int, like: dict, *,
            device=None) -> dict:
    """Load a committed step into the structure of ``like``.

    The model in ``like`` is filled in place (on its own device) and
    returned; an ``OptState`` comes back as new tensors on ``device``
    (default: the model's device), each leaf in ``like``'s dtype.  On-disk
    arrays are whole and device-free, so a checkpoint restores onto any
    device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree = _reference_layout(like, lambda t: t.to("meta"))
    leaves = _leaves(tree)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected "
            f"{len(leaves)} — structure mismatch")
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        t = torch.from_numpy(arr)
        if manifest["leaves"][i]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(ref.dtype))
    loaded = _unflatten(tree, iter(out))
    model = _model_of(like)
    result = {}
    for key, v in like.items():
        if isinstance(v, torch.nn.Module):
            result[key] = convert.load_reference_params(v, loaded[key])
        else:
            result[key] = convert.load_reference_opt_state(
                model, loaded[key], device)
    return result


def restore_latest(ckpt_dir: str, like: dict, *, device=None):
    """→ (state, step) or (None, -1) when no committed checkpoint exists."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, -1
    return restore(ckpt_dir, step, like, device=device), step
