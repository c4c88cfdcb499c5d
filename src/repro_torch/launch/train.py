"""Training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
        --smoke --device cpu --steps 200 --seq-len 64 --global-batch 8 \
        --ckpt-dir /tmp/run1

The port of the JAX package's ``launch/train.py``, with the same flags
plus ``--device`` (default ``cuda``).  Random weights from
``torch.Generator`` seed 0, ``SyntheticLMData`` batches, AdamW with fp32
master weights, ``--microbatches`` of gradient accumulation:

  * checkpoint every ``--save-every`` steps and at the last, atomic and
    resumable (restart the same command: it resumes from the latest
    committed step);
  * SIGTERM → checkpoint-and-exit (preemption guard).

Meshes (the reference's ``make_production_mesh`` / ``make_local_mesh``)
need one process per rank: the default process group, made by the
caller or from ``torchrun``'s environment (``WORLD_SIZE`` > 1; NCCL on
the cards, gloo on the CPU).

  * ``--production-mesh`` trains on the 16×16 ("data", "model") mesh and
    exits, naming the ranks it needs and found, on any other world size.
  * With more than one rank, it trains on ``make_local_mesh()`` (every
    rank on "data"): the parameters become DTensors under
    ``param_sharding_tree``'s placements, the activation rules are
    installed, each microbatch is placed by ``batch_sharding_tree``, and
    the microbatched step is the one-device step.  The plan is the
    config's (``sharding.rules_for``: pure DP for a ``prefer_pure_dp``
    config on a mesh without "pod"), as the dry-run reckons it; the
    reference's launcher passes no config and so always takes the TP
    plan.  Each rank takes card
    ``LOCAL_RANK``.  ``--ckpt-dir`` works on a mesh as on one device:
    every rank makes each leaf whole, rank 0 writes the one-device
    layout, and a resume places the leaves back on the mesh; a
    preemption seen by any rank stops them all at the same step.
  * With one rank it trains on ``--device``, as before.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, load_arch, load_smoke
from ..data.pipeline import SyntheticLMData
from ..models import build_model
from ..train import checkpoint as ckpt
from ..train.fault import PreemptionGuard
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_loop import init_train_state, make_train_step
from . import sharding as sh
from .mesh import make_local_mesh, make_production_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--production-mesh", action="store_true")
    return ap.parse_args(argv)


def _world(dev: torch.device) -> tuple:
    """(world size, whether this call made the process group): the
    caller's group, or torchrun's from the environment, or none (1)."""
    if dist.is_initialized():
        return dist.get_world_size(), False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        return dist.get_world_size(), True
    return 1, False


def _any_rank(flag: bool, mesh, dev) -> bool:
    """``flag`` on one device; on a mesh, whether any rank raised it (a
    max over the ranks), so that all take the same branch."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _value(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def run(argv=None, model=None) -> dict:
    """``main``'s work → ``{"model", "opt_state", "opt_cfg", "records"}``:
    the trained model and optimizer state, and one record per step run
    (``step``, ``loss``, ``grad_norm``, ``lr``, ``step_s`` and ``opt_s``
    host seconds ending in a device synchronize, ``tokens``, and on a
    card ``peak_bytes``, the allocator's peak so far).

    ``model``: a library caller's weights to train (a model of the
    config ``--arch``/``--smoke`` name, on ``--device``) in place of the
    random init from generator seed 0."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    world, made_group = _world(dev)
    try:
        return _run(args, dev, world, model)
    finally:
        sh.clear_activation_rules()
        if made_group:
            dist.destroy_process_group()


def _run(args, dev, world, model) -> dict:
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(device_type=dev.type)
    elif world > 1:
        mesh = make_local_mesh(device_type=dev.type)
    elif dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards visible, one rank: "
              f"training on {dev} alone (run one rank per card, e.g. "
              f"under torchrun, to train on a mesh)")
    if mesh is not None:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)

    cfg = load_smoke(args.arch) if args.smoke else load_arch(args.arch)
    opt_cfg = OptConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                        total_steps=args.steps)
    if model is None:
        model, opt_state = init_train_state(
            build_model(cfg, dev), torch.Generator(dev).manual_seed(0),
            opt_cfg)
    elif model.cfg != cfg or model.device != dev:
        raise ValueError(f"the model is {model.cfg.name} on {model.device}; "
                         f"the arguments name {cfg.name} on {dev}")
    else:
        opt_state = init_opt_state(model.parameters(), opt_cfg)
    place = None
    if mesh is not None:
        sh.distribute_params(model, mesh, cfg)
        opt_state = init_opt_state(model.parameters(), opt_cfg)
        sh.install_activation_rules(mesh, cfg)

        def place(batch):
            return sh.distribute_batch(mesh, batch, cfg)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              place_batch=place)
    data = SyntheticLMData(cfg, args.seq_len, args.global_batch)
    tokens = args.seq_len * args.global_batch
    guard = PreemptionGuard()

    records = []
    try:
        start = 0
        if args.ckpt_dir:
            state, at = ckpt.restore_latest(
                args.ckpt_dir, {"params": model, "opt": opt_state})
            if state is not None:
                opt_state = state["opt"]
                start = at + 1
                print(f"resumed from step {at}")

        for s in range(start, args.steps):
            t0 = time.perf_counter()
            opt_state, metrics = step_fn(opt_state, data.batch_at(s))
            rec = {"step": s, "loss": _value(metrics["loss"]),
                   "grad_norm": _value(metrics["grad_norm"]),
                   "lr": _value(metrics["lr"]),
                   "step_s": time.perf_counter() - t0,
                   "opt_s": metrics["opt_s"], "tokens": tokens}
            if dev.type == "cuda":
                rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            records.append(rec)
            if s % args.log_every == 0 or s == args.steps - 1:
                peak = (f", peak {rec['peak_bytes'] / 1e9:.2f} GB"
                        if "peak_bytes" in rec else "")
                print(f"step {s:5d} loss {rec['loss']:8.4f} "
                      f"gnorm {rec['grad_norm']:7.3f} lr {rec['lr']:.2e} "
                      f"[{rec['step_s'] * 1e3:.1f} ms, "
                      f"{tokens / rec['step_s']:,.0f} tok/s, optimizer "
                      f"{rec['opt_s'] * 1e3:.1f} ms{peak}]", flush=True)
            stop = _any_rank(guard.should_stop, mesh, dev)
            if args.ckpt_dir and (stop or (s and s % args.save_every == 0)
                                  or s == args.steps - 1):
                ckpt.save(args.ckpt_dir, s,
                          {"params": model, "opt": opt_state})
            if stop:
                print(f"preempted — checkpointed at step {s}, exiting "
                      f"cleanly")
                break
        else:
            print("done")
    finally:
        guard.restore_handlers()
    return {"model": model, "opt_state": opt_state, "opt_cfg": opt_cfg,
            "records": records}


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
