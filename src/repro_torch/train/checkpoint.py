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

A leaf is written and read one part at a time (a stacked leaf's layers
through a memory-mapped file), so no copy of the whole state is ever
made.  On a mesh (a model whose parameters are DTensors) every rank makes
each part whole (``full_tensor``, a collective), rank 0 writes it and the
others drop it at once, and all meet at a barrier, so the files are the
one-device layout.  A restore reads, for each rank, only its own block of
each part under the placements of ``like``'s DTensors, with no
communication (the reference's ``restore(..., shardings=)``): a
checkpoint moves from one device to a mesh, from a mesh to one device,
and across rank counts.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import convert
from .optimizer import OptState


def _model_of(state: dict):
    models = [v for v in state.values() if isinstance(v, torch.nn.Module)]
    if len(models) != 1:
        raise ValueError("a checkpoint state holds exactly one model")
    return models[0]


def _sharded(state: dict) -> bool:
    """Whether the state's model lives on a mesh (DTensor parameters)."""
    return isinstance(next(_model_of(state).parameters()), DTensor)


class _Leaf:
    """One leaf of the reference's tree: the state's own tensors it is
    made of, in order (a stacked leaf's layers; else one tensor)."""

    def __init__(self, parts: list, stacked: bool):
        self.parts, self.stacked = parts, stacked
        self.dtype = parts[0].dtype
        self.shape = (((len(parts),) if stacked else ()) +
                      tuple(parts[0].shape))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _layout(state: dict) -> dict:
    """The state as the reference's tree, each leaf a :class:`_Leaf` of
    the state's tensors (no copies): the tree of each tensor list is the
    reference tree of the lists' indices, so a leaf knows its parts."""
    model = _model_of(state)

    def tree(ts):
        ts = list(ts)
        idx = convert.reference_tree(
            model, [torch.tensor(i) for i in range(len(ts))])
        return _map(idx, lambda ix: _Leaf(
            [ts[i] for i in ix.reshape(-1).tolist()], ix.dim() > 0))
    out = {}
    for key, v in state.items():
        if isinstance(v, torch.nn.Module):
            out[key] = tree(v.parameters())
        elif isinstance(v, OptState):
            out[key] = (_Leaf([v.step], False), tree(v.mu), tree(v.nu),
                        tree(v.master) if len(v.master) else ())
        else:
            raise TypeError(f"{key}: cannot checkpoint a {type(v).__name__}")
    return out


def _block(shape: tuple, like: torch.Tensor) -> tuple:
    """The index (a tuple of slices) of this rank's block of a whole leaf
    of ``shape`` under a DTensor ``like``'s placements, each mesh dim in
    order splitting the block it is given as ``torch.chunk`` does (as a
    DTensor ``Shard`` splits); the whole leaf for a plain ``like``."""
    lo, n = [0] * len(shape), list(shape)
    if isinstance(like, DTensor):
        mesh, coord = like.device_mesh, like.device_mesh.get_coordinate()
        for i, p in enumerate(like.placements):
            if p.is_shard():
                d = p.dim
                size = -(-n[d] // mesh.size(i))
                a = min(coord[i] * size, n[d])
                lo[d], n[d] = lo[d] + a, min(size, n[d] - a)
    return tuple(slice(a, a + m) for a, m in zip(lo, n))


def _read(src: np.ndarray, like: torch.Tensor, bf16: bool) -> torch.Tensor:
    """This rank's block of one whole part, ``src`` (a view of a
    memory-mapped file), read alone into host memory."""
    t = torch.from_numpy(np.array(src[_block(src.shape, like)]))
    return t.view(torch.bfloat16) if bf16 else t


def _restored(like: torch.Tensor, block: torch.Tensor, device):
    """A new tensor like ``like`` holding ``block``: on a DTensor
    ``like``'s mesh and placements (``block`` is this rank's own), else on
    ``device`` (None: ``like``'s)."""
    if not isinstance(like, DTensor):
        return torch.empty(block.shape, dtype=like.dtype,
                           device=device or like.device).copy_(block)
    local = torch.empty_like(like.to_local()).copy_(block)
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              shape=like.shape, stride=like.stride())


def _leaves(tree) -> list:
    """``jax.tree.flatten``'s leaf order: dict keys sorted, tuples in
    order, ``()`` holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


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
    """Write one committed checkpoint; returns its path.  A leaf is
    written one part at a time (a stacked leaf's layers into a
    memory-mapped file), so the host holds one part.  On a mesh every
    rank calls it: each part is made whole (a collective), rank 0 writes
    it and the others drop it at once, and none returns before the
    commit."""
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    sharded = _sharded(state)
    write = not sharded or dist.get_rank() == 0
    if write:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    tree = _layout(state)
    leaves = _leaves(tree)
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "treedef": f"PyTreeDef({_structure(tree)})",
        "leaves": [_save_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf,
                              write) for i, leaf in enumerate(leaves)],
    }
    if write:
        _commit(ckpt_dir, name, manifest, keep)
    if sharded:
        dist.barrier()
    return final


def _save_leaf(path: str, leaf: _Leaf, write: bool):
    """Write ``leaf`` to ``path`` part by part → its manifest entry (None
    where this rank does not write)."""
    arr, entry = None, None
    for j, part in enumerate(leaf.parts):
        part = part.detach()
        if isinstance(part, DTensor):
            part = part.full_tensor()
        if not write:
            continue
        a, logical = _to_numpy(part.cpu())
        entry = {"shape": list(leaf.shape), "dtype": logical}
        if not leaf.stacked:
            np.save(path, a)
            continue
        if arr is None:
            arr = np.lib.format.open_memmap(path, mode="w+", dtype=a.dtype,
                                            shape=leaf.shape)
        arr[j] = a
    if arr is not None:
        arr.flush()
    return entry


def _commit(ckpt_dir: str, name: str, manifest: dict, keep: int) -> None:
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
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
    device.  On a mesh (DTensor parameters; every rank calls it) each
    parameter keeps its placements, each optimizer leaf takes those of
    ``like``'s and a plain one (the step) ``like``'s device.  The files are mapped in memory and read one part at a
    time, each rank reading only its own block of it, so a rank's host
    and device hold its shards plus one block."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree = _layout(like)
    leaves = _leaves(tree)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected "
            f"{len(leaves)} — structure mismatch")
    files = []
    for i, leaf in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"),
                      mmap_mode="r")
        if tuple(arr.shape) != leaf.shape:
            raise ValueError(f"leaf {i}: shape {arr.shape} != {leaf.shape}")
        files.append(arr)
    files = iter(zip(files, manifest["leaves"]))
    if device is not None:
        device = torch.device(device)
    elif not _sharded(like):
        device = _model_of(like).device
    result = {}
    for key in sorted(like):           # the leaves' order
        v, new = like[key], {}
        for leaf in _leaves(tree[key]):
            arr, meta = next(files)
            bf16 = meta["dtype"] == "bfloat16"
            for j, part in enumerate(leaf.parts):
                block = _read(arr[j] if leaf.stacked else arr, part, bf16)
                if isinstance(v, torch.nn.Module):
                    with torch.no_grad():
                        (part.to_local() if isinstance(part, DTensor)
                         else part).copy_(block)
                else:
                    new[id(part)] = _restored(part, block, device)
        result[key] = v if isinstance(v, torch.nn.Module) else OptState(
            new[id(v.step)], *([new[id(t)] for t in ts]
                               if len(ts) else () for ts in v[1:]))
    return {key: result[key] for key in like}


def restore_latest(ckpt_dir: str, like: dict, *, device=None):
    """→ (state, step) or (None, -1) when no committed checkpoint exists."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, -1
    return restore(ckpt_dir, step, like, device=device), step
