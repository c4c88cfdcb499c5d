"""The multi-pod dry-run: every cell placed on the production meshes.

The port of the JAX package's ``launch/dryrun.py``, with its CLI.  For
every (architecture × input shape) cell and both production meshes it
builds the step's model and inputs on the ``meta`` device, resolves the
sharding of every leaf on the 256- or 512-rank mesh, and records:

  * ``status``              — ``ok`` when every leaf's placements resolve
                              (each becomes a DTensor on the mesh), else
                              ``failed`` with the reason; ``skipped`` for
                              a shape the config does not support;
  * ``memory``              — reckoned bytes per rank (the reference's
                              ``memory_analysis`` layout) and ``fits_80g``;
  * ``scanned_cost``        — the reckoned bytes and collectives of the
                              whole stack (``flops`` null: not counted);
  * ``linearized_cost``,
    ``roofline``            — FLOPs counted on the 1-group/2-group cuts,
                              linearized, and the three time terms
                              (single-pod only; see roofline/extract.py).

The mesh lives in a process group of the ``"fake"`` backend over a
``FakeStore`` (no process per rank, no network): world 256 for
``--mesh single``, 512 for ``multi``.  The group is destroyed before the
run returns.  ``lower_s`` is the seconds to build the cell and place its
leaves, ``compile_s`` the seconds of the FLOP counts.

Usage:
    python -m repro_torch.launch.dryrun --arch granite_3_2b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi --no-cost
    python -m repro_torch.launch.dryrun --masksearch --mesh single

Results are cached as JSON under ``--out`` (default ``dryrun_results/``);
re-runs skip completed cells unless ``--force``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs.base import ARCH_IDS, SHAPES, load_arch
from ..roofline.extract import (Roofline, count_flops, reckon_cost,
                                reckon_memory)
from . import sharding as sh
from .mesh import HBM_BYTES, PRODUCTION, make_production_mesh
from .specs import build_cell, build_masksearch_cells


def _reduced_cfg(cfg, groups: int):
    """Config with the layer stack cut to ``groups`` groups (same
    prefix/tail structure), microbatching off — the cost-linearization
    variants."""
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, enc_layers=groups, dec_layers=groups,
                                   num_layers=groups,
                                   microbatches_train_4k=1,
                                   unroll_groups=True)
    glen = len(cfg.layer_pattern)
    prefix = cfg.first_k_dense if cfg.num_experts else 0
    tail = len(cfg.tail_layers)
    return dataclasses.replace(
        cfg, num_layers=prefix + groups * glen + tail,
        microbatches_train_4k=1, unroll_groups=True)


@contextlib.contextmanager
def fake_world(mesh_kind: str):
    """A process group of the ``"fake"`` backend with the production
    mesh's world size, destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(PRODUCTION[mesh_kind == "multi"][0])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place_leaves(cell) -> int:
    """Make every leaf of ``cell`` a DTensor on its mesh (meta storage),
    which fails unless its spec resolves to placements of the mesh's
    rank count → the number of leaves placed."""
    for leaf in cell.leaves:
        local = sh.local_shape(cell.mesh, leaf.spec, leaf.shape)
        if math.prod(local) * leaf.ways(cell.mesh) != math.prod(leaf.shape):
            raise ValueError(f"{leaf.name}: {leaf.shape} does not split "
                             f"evenly under {leaf.spec}")
        DTensor.from_local(
            torch.empty(local, dtype=leaf.dtype, device="meta"), cell.mesh,
            sh.placements_for(cell.mesh, leaf.spec), run_check=False,
            shape=torch.Size(leaf.shape),
            stride=torch.empty(leaf.shape, device="meta").stride())
    return len(cell.leaves)


def _costed(arch, cfg, shape_id, mesh, cell, n_chips) -> dict:
    """1-group / 2-group FLOP counts → linearized cost and roofline."""
    costs = []
    for g in (1, 2):
        rcell = build_cell(arch, _reduced_cfg(cfg, g), shape_id, mesh)
        costs.append(reckon_cost(rcell, count_flops(rcell.step_fn)))
    lin = costs[0].linearize(costs[1], cell.n_groups)
    roof = Roofline.from_cost(lin, n_chips, cell.model_flops)
    return dict(linearized_cost=dataclasses.asdict(lin),
                roofline=roof.to_dict(), n_groups=cell.n_groups)


def run_cell(arch: str, shape_id: str, mesh_kind: str, *, with_cost: bool,
             out_dir: str, force: bool = False,
             cost_only: bool = False) -> dict:
    """One cell's record (cached at ``out_dir/mesh_kind/arch__shape.json``);
    needs :func:`fake_world` of ``mesh_kind``."""
    path = os.path.join(out_dir, mesh_kind, f"{arch}__{shape_id}.json")
    record = {"arch": arch, "shape": shape_id, "mesh": mesh_kind}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
        if not force and not cost_only:
            return existing
        if cost_only:
            record = existing            # refresh only the 1g/2g linearization
    os.makedirs(os.path.dirname(path), exist_ok=True)

    cfg = load_arch(arch)
    ok, reason = cfg.supports_shape(shape_id)
    if not ok:
        record.update(status="skipped", reason=reason)
        _write(path, record)
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type="cpu")
    n_chips = mesh.size()
    if cost_only and record.get("status") == "ok":
        try:
            cell = build_cell(arch, cfg, shape_id, mesh)
            t0 = time.time()
            record.update(_costed(arch, cfg, shape_id, mesh, cell, n_chips))
            record["compile_s"] = round(time.time() - t0, 1)
        except Exception as e:
            record.update(roofline_error=f"{type(e).__name__}: {e}")
        _write(path, record)
        return record
    try:
        t0 = time.time()
        cell = build_cell(arch, cfg, shape_id, mesh)
        place_leaves(cell)
        t_lower = time.time() - t0
        mem = reckon_memory(cell)
        scanned = dataclasses.asdict(reckon_cost(cell))
        scanned["flops"] = None
        record.update(
            status="ok",
            kind=cell.kind,
            n_chips=n_chips,
            lower_s=round(t_lower, 1),
            compile_s=0.0,
            memory=mem,
            fits_80g=bool(mem["peak_estimate_bytes"] < HBM_BYTES),
            low_mem_opt=cell.low_mem_opt,
            scanned_cost=scanned,
            model_flops=cell.model_flops,
        )
        if with_cost:
            t0 = time.time()
            record.update(_costed(arch, cfg, shape_id, mesh, cell, n_chips))
            record["compile_s"] = round(time.time() - t0, 1)
    except Exception as e:  # a failing cell is a bug — record it loudly
        record.update(status="failed", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(path, record)
    return record


def run_masksearch(mesh_kind: str, out_dir: str, force: bool = False):
    """The four MaskSearch cells' records; needs :func:`fake_world`."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type="cpu")
    n_chips = mesh.size()
    results = []
    for cell in build_masksearch_cells(mesh):
        path = os.path.join(out_dir, mesh_kind,
                            f"masksearch__{cell.shape_id}.json")
        if os.path.exists(path) and not force:
            with open(path) as f:
                results.append(json.load(f))
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        record = {"arch": "masksearch", "shape": cell.shape_id,
                  "mesh": mesh_kind, "note": cell.note}
        try:
            t0 = time.time()
            place_leaves(cell)
            cost = reckon_cost(cell)
            roof = Roofline.from_cost(cost, n_chips, 0.0)
            record.update(status="ok", n_chips=n_chips,
                          lower_s=round(time.time() - t0, 1),
                          compile_s=0.0,
                          memory=reckon_memory(cell),
                          cost=dataclasses.asdict(cost),
                          roofline=roof.to_dict())
        except Exception as e:
            record.update(status="failed", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-4000:])
        _write(path, record)
        results.append(record)
    return results


def _write(path: str, record: dict):
    with open(path + ".tmp", "w") as f:
        json.dump(record, f, indent=1, default=float)
    os.replace(path + ".tmp", path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--masksearch", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the 1g/2g FLOP counts")
    ap.add_argument("--cost-only", action="store_true",
                    help="refresh only the 1g/2g linearization of cached cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="dryrun_results")
    args = ap.parse_args(argv)

    with_cost = not args.no_cost and args.mesh == "single"
    cells = ([(args.arch, args.shape)] if args.arch and args.shape else
             [(a, s) for a in ARCH_IDS for s in SHAPES] if args.all else None)
    if cells is None and not args.masksearch:
        raise SystemExit("pass --arch+--shape, --all, or --masksearch")
    with fake_world(args.mesh):
        if args.masksearch:
            for r in run_masksearch(args.mesh, args.out, args.force):
                _report(r)
            return 0
        for arch, shape in cells:
            r = run_cell(arch, shape, args.mesh, with_cost=with_cost,
                         out_dir=args.out, force=args.force,
                         cost_only=args.cost_only)
            _report(r)
    return 0


def _report(r: dict):
    status = r.get("status")
    if status == "ok":
        mem = r.get("memory", {})
        peak = mem.get("peak_estimate_bytes", 0) / 1e9
        roof = r.get("roofline") or {}
        print(f"[OK]   {r['arch']:22s} {r['shape']:16s} {r['mesh']:6s} "
              f"peak={peak:7.2f}GB/dev "
              f"dominant={roof.get('dominant', '-'):10s} "
              f"compile={r.get('compile_s', 0):6.1f}s", flush=True)
    elif status == "skipped":
        print(f"[SKIP] {r['arch']:22s} {r['shape']:16s} {r['mesh']:6s} "
              f"{r.get('reason', '')}", flush=True)
    else:
        print(f"[FAIL] {r['arch']:22s} {r['shape']:16s} {r['mesh']:6s} "
              f"{r.get('error', '')[:160]}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
