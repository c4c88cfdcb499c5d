"""Logical-axis → mesh-axis mapping (the sharding plan for every arch).

The port of the JAX package's ``launch/sharding.py``.  Models attach
*logical* axis names to every parameter (``models/layers.py``: each
``nn.Parameter`` carries ``.axes``) and annotate activations with
``shard_act``; this module turns them into a per-dim spec for a mesh,
with the reference's two safety rules:

  * **divisibility** — a mesh axis is only used if it divides the dimension
    (GQA kv=8 on a 16-way "model" axis falls back to replication);
  * **single-use** — a mesh axis appears at most once per spec (e.g. the
    RG-LRU (w, w) square matrices shard only one side).

A spec is a tuple with one entry per tensor dim: ``None``, a mesh-axis
name, or a tuple of names (the dim split over all of them, the first
major).  :func:`placements_for` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` where the mesh axis splits dim ``d`` (a dim over
``("data", "pod")`` is ``Shard(d)`` on both), ``Replicate()`` elsewhere
and on a mesh dim of one rank (its one shard is the whole tensor).

The plan (the reference's DESIGN.md §6):
  params   — FSDP ("embed" over data×pod, ZeRO-3) × TP ("model" on
             heads/mlp/vocab) × EP (experts over "model");
  acts     — batch over data×pod, heads/mlp/vocab over "model";
  caches   — decode KV **sequence** over "model" (flash-decoding SP);
             SSM/RG-LRU states shard heads/width over "model".
"""

from __future__ import annotations

import functools
import math

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from ..models import layers as L
from ..models import moe

# Candidate mesh axes per logical axis, in priority order.  Tuples are used
# jointly (FSDP over data AND pod); the resolver drops members that are
# absent, already used, or non-divisible.
PARAM_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "embed": ("data", "pod"),          # ZeRO-3 / FSDP
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "expert_mlp": (),                  # experts already take "model"
    "experts": ("model",),
    "q_lora": (), "kv_lora": (), "head_dim": (), "conv": (),
    "state": (), "mlp2": (), "layers": (),
}

ACT_RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),         # flattened (B·S) MoE dispatch rows
    "seq": (),
    "embed": (),
    "mlp": ("model",),
    "expert_mlp": (),
    "experts": ("model",),
    "heads": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),              # seq-parallel cross/decode KV
}

# Pure-DP variant (small dense models): batch over the whole mesh, no
# tensor parallelism; vocab keeps "model" (free in fwd, one small AR in
# bwd) so the logits never replicate.
PURE_DP_PARAM_RULES = dict(PARAM_RULES, **{
    "q_heads": (), "kv_heads": (), "heads": (), "mlp": (), "experts": (),
    "embed": ("data",),                # ZeRO over data only
})
PURE_DP_ACT_RULES = dict(ACT_RULES, **{
    "batch": ("pod", "data", "model"),
    "tokens": ("pod", "data", "model"),
    "mlp": (), "heads": (), "q_heads": (), "kv_heads": (), "experts": (),
})


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names`` and
    ``shape``) or of any object with ``axis_names`` and a ``shape`` dict,
    as the reference's ``Mesh`` has."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {ax: int(mesh.shape[ax]) for ax in mesh.axis_names}


def rules_for(cfg=None, mesh=None):
    """(param_rules, act_rules) for a config (pure-DP override aware).

    Pure DP only pays when the global batch covers the whole mesh (train_4k
    batch 256 == the 256-rank single pod); on the 512-rank multi-pod mesh
    the same batch cannot, so those cells keep the TP mapping."""
    if cfg is not None and getattr(cfg, "prefer_pure_dp", False):
        if mesh is None or "pod" not in mesh_axes(mesh):
            return PURE_DP_PARAM_RULES, PURE_DP_ACT_RULES
    return PARAM_RULES, ACT_RULES


def _resolve_dim(mesh, cand: tuple, size: int, used: set):
    """Pick the largest usable prefix of candidate axes for one dimension."""
    sizes = mesh_axes(mesh)
    picked = []
    prod = 1
    for ax in cand:
        if ax not in sizes or ax in used:
            continue
        n = sizes[ax]
        if size % (prod * n) == 0:
            picked.append(ax)
            prod *= n
    for ax in picked:
        used.add(ax)
    if not picked:
        return None
    return tuple(picked) if len(picked) > 1 else picked[0]


def spec_for(mesh, rules: dict, axes: tuple, shape: tuple) -> tuple:
    """One entry per dim: ``None``, a mesh-axis name or a tuple of them."""
    used: set = set()
    out = []
    for name, size in zip(axes, shape):
        if name is None:
            out.append(None)
            continue
        cand = rules.get(name, ())
        out.append(_resolve_dim(mesh, cand, int(size), used))
    return tuple(out)


def placements_for(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim (a
    mesh dim of one rank replicates)."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    sizes = mesh_axes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if sizes[ax] > 1:
                out[names.index(ax)] = Shard(d)
    return out


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """The per-rank shard shape of a ``shape`` tensor under ``spec`` (the
    resolver only picks axes that divide their dim)."""
    sizes = mesh_axes(mesh)
    out = []
    for size, entry in zip(shape, spec):
        for ax in (() if entry is None else
                   entry if isinstance(entry, tuple) else (entry,)):
            size //= sizes[ax]
        out.append(size)
    return tuple(out)


def param_specs(mesh, model, cfg=None) -> dict:
    """{parameter name: spec} over ``model.named_parameters()``, from each
    parameter's logical ``.axes``."""
    rules = rules_for(cfg, mesh)[0]
    return {name: spec_for(mesh, rules, L.axes_of(p, name), tuple(p.shape))
            for name, p in model.named_parameters()}


def param_sharding_tree(mesh, model, cfg=None) -> dict:
    """{parameter name: placements} for ``model`` on ``mesh``."""
    return {name: placements_for(mesh, spec)
            for name, spec in param_specs(mesh, model, cfg).items()}


def _put(mesh, x, placements) -> DTensor:
    """``x`` (the same whole tensor on every rank) as a DTensor: each
    rank keeps its own shard, with no communication."""
    return distribute_tensor(torch.as_tensor(x), mesh, placements,
                             src_data_rank=None)


@torch.no_grad()
def distribute_params(model, mesh, cfg=None):
    """Replace each of ``model``'s parameters (the same values on every
    rank) by a DTensor parameter under :func:`param_sharding_tree`'s
    placements; the logical ``.axes`` stay on it.  Returns the model."""
    placements = param_sharding_tree(mesh, model, cfg)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        new = torch.nn.Parameter(_put(mesh, p.detach(), placements[name]),
                                 requires_grad=p.requires_grad)
        new.axes = p.axes
        setattr(module, leaf, new)
    return model


def distribute_cache(mesh, cache) -> list:
    """A port cache with each leaf a DTensor under
    :func:`cache_sharding_tree`'s placements: a plain leaf (the same on
    every rank) keeps its own shard, and a DTensor leaf, as a decode step
    left it, is redistributed (the reference's ``out_shardings`` of its
    serve step)."""
    placements = cache_sharding_tree(mesh, cache)
    return [{name: (leaf.redistribute(mesh, placements[i][name])
                    if isinstance(leaf, DTensor) else
                    _put(mesh, leaf, placements[i][name]))
             for name, leaf in layer.items()}
            for i, layer in enumerate(cache)]


def distribute_batch(mesh, batch: dict, cfg=None) -> dict:
    """A batch (host arrays or tensors, whole on every rank) as DTensors
    under :func:`batch_sharding_tree`'s placements, on the mesh's device
    type."""
    dev = torch.device(mesh.device_type)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    placements = batch_sharding_tree(mesh, batch, cfg)
    return {k: _put(mesh, v, placements[k]) for k, v in batch.items()}


def install_activation_rules(mesh, cfg=None) -> None:
    """Hook models' ``shard_act`` onto this mesh (launcher entry point): a
    DTensor activation is redistributed to its logical axes' placements;
    a plain tensor passes unchanged.  The mesh's versions of the models'
    ``mesh_op``s (below) are installed with it."""
    rules = rules_for(cfg, mesh)[1]

    def rule(x, axes):
        if not isinstance(x, DTensor):
            return x
        spec = spec_for(mesh, rules, axes, tuple(x.shape))
        want = placements_for(mesh, spec)
        if list(x.placements) == want:
            return x
        return x.redistribute(mesh, want)
    L.set_activation_rule(
        rule, write_seq=_write_seq, split_dim=_split_dim,
        merge_dims=_merge_dims, fill_from=_fill_from, whole=_whole,
        expert_buffers=functools.partial(_expert_buffers, rules),
        expert_combine=functools.partial(_expert_combine, rules))


def clear_activation_rules() -> None:
    L.set_activation_rule(None)


# -- the models' mesh ops on DTensors ----------------------------------------
# Each is its ``models.layers`` namesake on a plain tensor.


def _write_seq(dst, start: int, src) -> None:
    """A cache write along the sequence dim.  DTensor has no strategy for
    an in-place copy into a slice of a sharded dim, so each rank writes
    the part of ``src`` (first brought to ``dst``'s placements with the
    sequence dim whole) that falls in its own slots: the resolver only
    splits a dim evenly, so rank ``i`` of the dim's shards holds slots
    ``[i·n, (i+1)·n)``, ``n`` its local length."""
    if not isinstance(dst, DTensor):
        dst[:, start:start + src.shape[1]] = src
        return
    mesh = dst.device_mesh
    whole = [Replicate() if p.is_shard(1) else p for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, replicated(mesh))
    src = src.redistribute(mesh, whole).to_local()
    local = dst.to_local()
    lo, n = _block(mesh, dst.placements, 1, dst.shape[1])
    a, b = max(start, lo), min(start + src.shape[1], lo + n)
    if a < b:
        local[:, a - lo:b - lo] = src[:, a - start:b - start]


def _split_dim(x, dim: int, sizes: tuple):
    """``x.unflatten(dim, sizes)``.  DTensor's view strategy refuses to
    split a dim sharded over more ranks than ``sizes[0]`` divides (a
    mesh may split a matmul's output columns where the heads do not
    split), so such a dim is made whole first."""
    if isinstance(x, DTensor):
        dim %= x.ndim
        ways = math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements)
                         if p.is_shard(dim))
        if sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(dim) else p
                for p in x.placements])
    return x.unflatten(dim, sizes)


class _Merge(torch.autograd.Function):
    """``flatten(dim, dim + 1)`` whose backward splits with
    :func:`_split_dim` (DTensor's view strategy refuses the backward's
    uneven split, as above)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return _split_dim(g, ctx.dim, ctx.sizes), None


def _merge_dims(x, dim: int):
    dim %= x.ndim
    if isinstance(x, DTensor):
        return _Merge.apply(x, dim)
    return x.flatten(dim, dim + 1)


def _fill_from(x, start: int, value: float):
    """``x[..., start:] = value``; DTensor has no strategy for an in-place
    fill of a slice, so on a DTensor it is an out-of-place masked fill."""
    if not isinstance(x, DTensor):
        x[..., start:] = value
        return x
    return x.masked_fill(torch.arange(x.shape[-1], device=x.device) >= start,
                         value)


def _block(mesh, placements, dim: int, size: int) -> tuple:
    """(start, length) of this rank's block of a dim of ``size`` that
    ``placements`` split: the resolver only splits a dim evenly, and a
    dim split over several mesh dims takes the first mesh dim major."""
    coord, shard, ways = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            shard = shard * mesh.size(i) + coord[i]
            ways *= mesh.size(i)
    return shard * (size // ways), size // ways


def _whole(x):
    """A DTensor made whole on every rank, as a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _ep_plan(rules, mesh, t: int, e: int, c: int, d: int):
    """The expert-parallel layout of one MoE call on ``mesh``: the
    placements of the (T, d) token rows (the ``"tokens"`` rule) and of the
    (E, C, d) expert buffers (``"experts"``)."""
    tok = placements_for(mesh, spec_for(mesh, rules, ("tokens", "embed"),
                                        (t, d)))
    exp = placements_for(mesh, spec_for(mesh, rules,
                                        ("experts", None, "embed"),
                                        (e, c, d)))
    if any(a.is_shard() and b.is_shard() for a, b in zip(tok, exp)):
        raise ValueError("a mesh axis splits both the MoE's tokens and its "
                         "experts")
    return tok, exp


def _dims(placements) -> list:
    return [i for i, p in enumerate(placements) if p.is_shard()]


def _partial_where(placements, split) -> list:
    """``placements`` with ``Partial()`` on the mesh dims that ``split``
    shards: for a local tensor (a value or a gradient) that is this
    rank's part of a sum over those dims."""
    return [Partial() if s.is_shard() else p
            for p, s in zip(placements, split)]


def ep_bytes(mesh, cfg, tokens: int) -> dict:
    """The bytes one rank sends in one MoE call of ``tokens`` tokens on
    ``mesh`` (a ``DeviceMesh`` or any object with ``mesh_dim_names``,
    ``shape`` and ``ndim``) under the config's plan, reckoned from the
    placements as the mesh ops move them, each all-reduce over a mesh dim
    of ``n`` ranks a ring's ``2·(n−1)/n`` of its tensor, the gather of
    the expert ids an all-gather's ``(n−1)/n`` of the whole:

    * ``routing``: the (T·k,) int64 expert ids gathered (``whole``);
    * ``dispatch``: the local (E/e, C, d) buffer summed over the
      token-split dims (``expert_buffers``);
    * ``combine``: the (T/t, k, d) rows summed over the expert-split dims
      (``expert_combine``).

    The ops' backward passes send nothing: they hand back ``Partial``
    gradients, which the step sums once each where DTensor's strategies
    next need them whole, and ``train`` reckons each at its own size: the
    expert outputs' (E/e, C, d) over the token-split dims, and the (T/t,
    d) token rows' and the (T/t, k) float32 weights' over the
    expert-split dims.

    → {part: bytes}, with ``forward`` and ``train`` (forward + those
    gradient sums) totals."""
    e, k, d = cfg.num_experts, cfg.top_k, cfg.d_model
    c = moe.capacity(cfg, tokens)
    b = 2 if cfg.dtype == "bfloat16" else 4
    tok, exp = _ep_plan(rules_for(cfg, mesh)[1], mesh, tokens, e, c, d)
    sizes = list(mesh_axes(mesh).values())
    t_ways = math.prod(sizes[i] for i in _dims(tok))
    e_ways = math.prod(sizes[i] for i in _dims(exp))

    def ring(dims, nbytes):
        return sum(2 * (sizes[i] - 1) / sizes[i] * nbytes for i in dims)

    rows = tokens // t_ways
    out = {"routing": (t_ways - 1) / t_ways * tokens * k * 8,
           "dispatch": ring(_dims(tok), e // e_ways * c * d * b),
           "combine": ring(_dims(exp), rows * k * d * b)}
    out["forward"] = sum(out.values())
    out["train"] = (out["forward"] + out["dispatch"] +
                    ring(_dims(exp), rows * d * b + rows * k * 4))
    return out


# the MoE ops' plain versions, for a plain tensor while the rules are on
_PLAIN_BUFFERS = moe.expert_buffers.__wrapped__
_PLAIN_COMBINE = moe.expert_combine.__wrapped__


def _expert_buffers(rules, xf, route):
    """The (E, C, d) expert buffers on a mesh, experts split as the
    ``"experts"`` rule says (expert parallelism): each rank fills only
    its own experts' rows from its own block of tokens, and the blocks of
    the token-split mesh dims are summed (each kept row has a slot of its
    own, so the sum is exact).  Dropped rows add nothing."""
    if not isinstance(xf, DTensor):
        return _PLAIN_BUFFERS(xf, route)
    mesh = xf.device_mesh
    t, d = xf.shape
    tok, exp = _ep_plan(rules, mesh, t, route.e, route.c, d)
    (t0, tn), (e0, en) = _block(mesh, tok, 0, t), _block(mesh, exp, 0, route.e)
    # the rows' gradient is this rank's experts' part of the whole
    xl = xf.redistribute(mesh, tok).to_local(
        grad_placements=_partial_where(tok, exp))
    mine = (route.keep & (route.st >= t0) & (route.st < t0 + tn) &
            (route.se >= e0) & (route.se < e0 + en)).nonzero()[:, 0]
    buf = torch.zeros((en, route.c, d), dtype=xl.dtype, device=xl.device)
    buf = buf.index_put((route.se[mine] - e0, route.slot[mine]),
                        xl[route.st[mine] - t0], accumulate=True)
    return DTensor.from_local(buf, mesh, _partial_where(exp, tok)
                              ).redistribute(mesh, exp)


def _expert_combine(rules, out_buf, topw, route):
    """The expert outputs back at their tokens on a mesh: each rank takes
    the rows of its block of tokens that its experts computed, weighted
    (``topw`` made token-split), the expert-split mesh dims sum them, so
    every row is whole where its token lives, and each token's k rows are
    summed left to right in sorted order, as :func:`moe.combine` sums
    them.  Returns the (T, d) output split as the ``"tokens"`` rule
    says."""
    if not isinstance(out_buf, DTensor):
        return _PLAIN_COMBINE(out_buf, topw, route)
    mesh = out_buf.device_mesh
    e, c, d = out_buf.shape
    t, k = topw.shape
    tok, exp = _ep_plan(rules, mesh, t, e, c, d)
    (t0, tn), (e0, en) = _block(mesh, tok, 0, t), _block(mesh, exp, 0, e)
    # this rank's experts' outputs (their gradient: its own tokens' part)
    # and its tokens' weights (their gradient: its own experts' part)
    ol = out_buf.redistribute(mesh, exp).to_local(
        grad_placements=_partial_where(exp, tok))
    wl = topw.redistribute(mesh, tok).to_local(
        grad_placements=_partial_where(tok, exp))
    # each local token's k assignments, in sorted order
    sorted_pos = torch.empty_like(route.order)
    sorted_pos[route.order] = torch.arange(t * k, device=route.order.device)
    j = sorted_pos.view(t, k).sort(dim=-1).values[t0:t0 + tn]
    se, slot = route.se[j], route.slot[j]
    w = torch.where(route.keep[j], wl.gather(1, route.order[j] % k),
                    torch.zeros((), device=wl.device))
    have = (se >= e0) & (se < e0 + en)
    rows = ol[torch.where(have, se - e0, 0), slot] * w[..., None].to(ol.dtype)
    rows = torch.where(have[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    rows = DTensor.from_local(rows, mesh, _partial_where(tok, exp)
                              ).redistribute(mesh, tok).to_local()
    yf = rows[:, 0]
    for i in range(1, k):
        yf = yf + rows[:, i]
    return DTensor.from_local(yf, mesh, tok)


# -- cache shardings (decode / prefill) --------------------------------------

_CACHE_LEAF_AXES = {
    # leaf-name → logical axes by rank
    "k": ("batch", "kv_seq", "kv_heads_repl", None),
    "v": ("batch", "kv_seq", "kv_heads_repl", None),
    "xk": ("batch", "kv_seq", "kv_heads_repl", None),
    "xv": ("batch", "kv_seq", "kv_heads_repl", None),
    "ckv": ("batch", "kv_seq", None),
    "kpe": ("batch", "kv_seq", None),
    "state": ("batch", "heads", None, None),
    "conv": ("batch", None, "mlp"),
    "h": ("batch", "mlp"),
}

_CACHE_RULES = dict(ACT_RULES)
_CACHE_RULES["kv_heads_repl"] = ()     # seq takes "model"; heads replicate


def cache_spec(mesh, name: str, shape: tuple) -> tuple:
    """The spec of one cache leaf, by its name (the reference's
    ``cache_sharding_tree`` for one leaf; an unknown name replicates)."""
    axes = _CACHE_LEAF_AXES.get(name)
    rank = len(shape)
    if axes is None:
        return (None,) * rank
    axes = axes[:rank] if len(axes) >= rank else axes + (None,) * (
        rank - len(axes))
    return spec_for(mesh, _CACHE_RULES, axes, shape)


def cache_sharding_tree(mesh, cache) -> list:
    """Placements for a port cache: one ``{leaf name: tensor}`` dict per
    layer (the reference stacks group caches on a leading layer axis; the
    port keeps one dict per layer, so there is no layer axis to skip)."""
    return [{name: placements_for(mesh, cache_spec(mesh, name,
                                                   tuple(leaf.shape)))
             for name, leaf in layer.items()} for layer in cache]


def batch_spec(mesh, shape: tuple, cfg=None) -> tuple:
    rules = rules_for(cfg, mesh)[1]
    return spec_for(mesh, rules, ("batch",) + (None,) * (len(shape) - 1),
                    shape)


def batch_sharding_tree(mesh, batch: dict, cfg=None) -> dict:
    """Token/label/feature batches: axis 0 (batch) over the data axes."""
    return {k: placements_for(mesh, batch_spec(mesh, tuple(v.shape), cfg))
            for k, v in batch.items()}


def replicated(mesh) -> list:
    return [Replicate()] * mesh.ndim
