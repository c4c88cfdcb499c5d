"""Abstract input specs for every (arch × shape) dry-run cell.

The port of the JAX package's ``launch/specs.py``.  ``build_cell(arch,
cfg, shape_id, mesh)`` returns a :class:`Cell`: the step to cost and
every leaf it reads or keeps (parameters, optimizer state, gradients,
batch, cache) with its global shape, dtype and sharding spec on the mesh.
Nothing is allocated: the model is built on the ``meta`` device, where a
step runs for its shapes alone (the reference's ``ShapeDtypeStruct``
inputs; a ``torch.Generator`` cannot draw on ``meta``, so no weights are
drawn).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..configs.base import SHAPES, ModelConfig
from ..models import build_model
from ..models.layers import axes_of
from ..train.optimizer import OptConfig
from . import sharding as sh

META = torch.device("meta")
_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4,
          torch.int64: 8, torch.bool: 1}


@dataclasses.dataclass
class Leaf:
    """One tensor of a cell: where it belongs (``role``: param, opt, grad,
    batch, cache, out), its global shape and dtype, its spec, and the
    share of its bytes a step reads (a query reads part of its inputs:
    ROI pixels, CHI corners)."""

    name: str
    role: str
    shape: tuple
    dtype: torch.dtype
    spec: tuple
    reads: float = 1.0             # the share of it a step reads

    def ways(self, mesh, axes=None) -> int:
        """Ranks the leaf is split over (only ``axes``' when given)."""
        sizes = sh.mesh_axes(mesh)
        n = 1
        for entry in self.spec:
            for ax in (() if entry is None else
                       entry if isinstance(entry, tuple) else (entry,)):
                if axes is None or ax in axes:
                    n *= sizes[ax]
        return n

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _BYTES[self.dtype]


@dataclasses.dataclass
class Cell:
    arch: str
    shape_id: str
    kind: str                      # train | prefill | decode | query
    step_fn: Callable              # runs the step on meta (or, for the
    leaves: list                   #  MaskSearch cells, the mesh step)
    n_groups: int                  # layer groups (for cost linearization)
    model_flops: float
    mesh: object = None
    cfg: Optional[ModelConfig] = None
    tokens: int = 0                # tokens of one step, all ranks
    batch_axes: tuple = ()         # mesh axes the batch splits over
    low_mem_opt: bool = False
    note: str = ""


def _opt_cfg_for(cfg: ModelConfig) -> OptConfig:
    # ≥100B-param MoE cells use the low-mem optimizer policy (the
    # reference's DESIGN.md §6)
    big = cfg.num_experts >= 64 and cfg.d_model >= 5000
    if big:
        return OptConfig(moments_dtype="bfloat16", use_master=False)
    return OptConfig()


def abstract_init(model) -> tuple:
    """({name: meta tensor}, {name: logical axes}) of a model built on
    ``meta`` — shapes and dtypes, no allocation, no weights drawn."""
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device=META)
              for n, p in model.named_parameters()}
    axes = {n: axes_of(p, n) for n, p in model.named_parameters()}
    return shapes, axes


def _batch_shapes(cfg: ModelConfig, kind: str, seq_len: int,
                  batch: int) -> dict:
    """name → (shape, dtype): the reference's ``_batch_specs`` shapes."""
    i32, f32 = torch.int32, torch.float32
    if cfg.is_encoder_decoder:
        dec = min(cfg.max_decode_len, seq_len)
        shapes = {"audio_feats": ((batch, seq_len, cfg.d_model), f32),
                  "tokens": ((batch, dec), i32),
                  "labels": ((batch, dec), i32)}
    else:
        text_len = seq_len - (cfg.num_patches or 0)
        shapes = {"tokens": ((batch, text_len), i32),
                  "labels": ((batch, text_len), i32)}
        if cfg.num_patches:
            shapes["patches"] = ((batch, cfg.num_patches, cfg.d_model), f32)
        if cfg.mtp_depth:
            shapes["labels_mtp"] = ((batch, text_len), i32)
    if kind == "prefill":
        shapes.pop("labels", None)
        shapes.pop("labels_mtp", None)
    return shapes


def _meta(shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=META)


def build_cell(arch: str, cfg: ModelConfig, shape_id: str, mesh,
               *, microbatches: Optional[int] = None) -> Cell:
    from ..roofline.extract import model_flops_for

    spec = SHAPES[shape_id]
    kind, seq_len, batch = spec["kind"], spec["seq_len"], spec["global_batch"]
    model = build_model(cfg, META)
    opt_cfg = _opt_cfg_for(cfg)
    mf = model_flops_for(cfg, kind, seq_len, batch)
    n_groups = (cfg.dec_layers if cfg.is_encoder_decoder else
                max(cfg.num_groups, 1))
    pspecs = sh.param_specs(mesh, model, cfg)
    shapes, _ = abstract_init(model)
    leaves = [Leaf(n, "param", tuple(t.shape), t.dtype, pspecs[n])
              for n, t in shapes.items()]
    bshapes = _batch_shapes(cfg, kind, seq_len, batch)
    if kind == "decode":
        bshapes = {"tokens": ((batch, 1), torch.int32)}
    leaves += [Leaf(n, "batch", s, d, sh.batch_spec(mesh, s, cfg))
               for n, (s, d) in bshapes.items()]
    batch_axes = tuple(ax for ax in sh.rules_for(cfg, mesh)[1]["batch"]
                       if ax in sh.mesh_axes(mesh))
    meta_batch = {n: _meta(s, d) for n, (s, d) in bshapes.items()}

    if kind == "train":
        mb = microbatches if microbatches is not None else \
            cfg.microbatches_train_4k
        if (cfg.prefer_pure_dp and "pod" in sh.mesh_axes(mesh)
                and microbatches is None):
            # multi-pod keeps the TP mapping (sharding.rules_for), so the
            # pure-DP mb=1 choice no longer holds — re-enable accumulation
            mb = max(mb, 4)
        moments = {"float32": torch.float32,
                   "bfloat16": torch.bfloat16}[opt_cfg.moments_dtype]
        grad_dtype = None if mb == 1 else torch.float32
        for leaf in [x for x in leaves if x.role == "param"]:
            state = [("mu", moments), ("nu", moments)]
            if opt_cfg.use_master:
                state.append(("master", torch.float32))
            leaves += [Leaf(f"{leaf.name}.{s}", "opt", leaf.shape, d,
                            leaf.spec) for s, d in state]
            leaves.append(Leaf(f"{leaf.name}.grad", "grad", leaf.shape,
                               grad_dtype or leaf.dtype, leaf.spec))

        def step():
            model.loss(meta_batch)[0].backward()
        return Cell(arch, shape_id, kind, step, leaves, n_groups, mf,
                    mesh=mesh, cfg=cfg, tokens=batch * seq_len,
                    batch_axes=batch_axes,
                    low_mem_opt=not opt_cfg.use_master)

    # serving cells ---------------------------------------------------------
    with torch.no_grad():
        cache = model.init_cache(batch, seq_len)
    for i, layer in enumerate(cache):
        leaves += [Leaf(f"{i}.{n}", "cache", tuple(t.shape), t.dtype,
                        sh.cache_spec(mesh, n, tuple(t.shape)))
                   for n, t in layer.items()]
    vocab = Leaf("logits", "out", (batch, 1, cfg.padded_vocab),
                 torch.float32 if cfg.dtype == "float32" else torch.bfloat16,
                 sh.spec_for(mesh, sh.rules_for(cfg, mesh)[1],
                             ("batch", "seq", "vocab"),
                             (batch, 1, cfg.padded_vocab)))
    leaves.append(vocab)
    if kind == "prefill":
        def step():
            model.prefill(meta_batch, cache)
        tokens = batch * seq_len
    else:
        def step():
            model.decode_step(cache, meta_batch["tokens"], seq_len - 1)
        tokens = batch
    return Cell(arch, shape_id, kind, step, leaves, n_groups, mf, mesh=mesh,
                cfg=cfg, tokens=tokens, batch_axes=batch_axes)


# ---------------------------------------------------------------------------
# MaskSearch query-engine cells (the paper's technique on the same meshes)
# ---------------------------------------------------------------------------

MS_DB = dict(n_masks=1 << 22, height=256, width=256, grid=16, num_bins=16,
             verify_batch=1 << 16, groups=1 << 18, group_size=2)

# What a query step reads of its inputs, for the memory term.  An ROI's
# sides are drawn uniformly from [16, 128) pixels (as chip_smoke.py's
# cells draw them): a mean side of 71.5, so cp_count and mask_agg read
# 71.5² of a 256×256 mask's pixels.  The CHI bounds gather 8 corners for
# each of the lower and upper bound: 16 int32, each in a 32-byte sector
# of its own, of a 17×17×17 int32 table.
MS_ROI_SIDES = (16, 128)
MS_ROI_SHARE = (sum(MS_ROI_SIDES) - 1) ** 2 / 4 / (
    MS_DB["height"] * MS_DB["width"])
MS_CORNER_SHARE = 16 * 32 / ((MS_DB["grid"] + 1) ** 2 *
                             (MS_DB["num_bins"] + 1) * 4)


def build_masksearch_cells(mesh, devices=None, db=None) -> list[Cell]:
    """The four cells of the reference over ``mesh`` (a ``DeviceMesh``
    or anything with ``axis_names`` and a ``shape`` dict): each a
    ``core.distributed`` step over a row-sharded DB on ``devices`` (by
    default ``meta``, one per rank: the dry-run builds the steps without
    running them) and its input and output leaves.  ``db`` overrides
    ``MS_DB``'s sizes (a cut)."""
    from ..core import distributed as dist

    db = dict(MS_DB, **(db or {}))
    sizes = sh.mesh_axes(mesh)
    names = tuple(sizes)
    n_dev = math.prod(sizes.values())
    cmesh = dist.Mesh(tuple(sizes.values()), names,
                      devices if devices is not None else [META] * n_dev)
    rows = names                      # rows shard over every mesh axis
    g1, nb1 = db["grid"] + 1, db["num_bins"] + 1
    h, w = db["height"], db["width"]
    i32, f32, b1 = torch.int32, torch.float32, torch.bool

    def row(name, shape, dtype, role="batch", reads=1.0):
        return Leaf(name, role, shape, dtype,
                    (rows,) + (None,) * (len(shape) - 1), reads)

    n = db["n_masks"]
    tables = row("tables", (n, g1, g1, nb1), i32, reads=MS_CORNER_SHARE)
    rois = row("rois", (n, 4), i32)
    cells = [Cell("masksearch", "filter_bounds_4m", "query",
                  dist.make_filter_bounds_step(cmesh, "<"),
                  [tables, rois, row("accept", (n,), b1, "out"),
                   row("undecided", (n,), b1, "out")], 1, 0.0, mesh=mesh,
                  note="CHI bounds+verdicts over 4.2M-mask DB")]
    topk_fn, n_cand = dist.make_topk_step(cmesh, k=64, desc=True)
    cells.append(Cell("masksearch", "topk_bounds_4m", "query", topk_fn,
                      [tables, rois, row("ids", (n,), i32),
                       row("survivors", (n,), b1, "out"),
                       Leaf("candidates", "out", (n_cand, 2), i32,
                            (None, None))], 1, 0.0, mesh=mesh,
                      note="distributed top-k candidate selection"))
    v = db["verify_batch"]
    cells.append(Cell("masksearch", "verify_64k", "query",
                      dist.make_verify_step(cmesh),
                      [row("masks", (v, h, w), f32, reads=MS_ROI_SHARE),
                       row("rois", (v, 4), i32),
                       row("counts", (v,), i32, "out")], 1, 0.0, mesh=mesh,
                      note="exact-CP verification round (64k masks)"))
    ng, s = db["groups"], db["group_size"]
    cells.append(Cell("masksearch", "iou_agg_256k", "query",
                      dist.make_iou_agg_step(cmesh),
                      [row("group_masks", (ng, s, h, w), f32,
                           reads=MS_ROI_SHARE),
                       row("rois", (ng, 4), i32),
                       row("iou", (ng,), f32, "out")], 1, 0.0, mesh=mesh,
                      note="fused MASK_AGG IoU over 262k image groups"))
    return cells
