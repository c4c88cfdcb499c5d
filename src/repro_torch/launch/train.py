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

The port trains on one device: ``--production-mesh`` is refused until the
launcher's mesh is ported (ROADMAP §1 item 3), and with several visible
cards it trains on ``--device`` and says so.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, load_arch, load_smoke
from ..data.pipeline import SyntheticLMData
from ..models import build_model
from ..train import checkpoint as ckpt
from ..train.fault import PreemptionGuard
from ..train.optimizer import OptConfig, init_opt_state
from ..train.train_loop import init_train_state, make_train_step


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
    if args.production_mesh:
        raise SystemExit("--production-mesh: the launcher's mesh is not "
                         "ported to PyTorch yet (ROADMAP §1 item 3); the "
                         "port trains on one --device")
    dev = torch.device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"{torch.cuda.device_count()} cards visible; training on "
              f"{dev} alone (no mesh in the port yet)")

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
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
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
            rec = {"step": s, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
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
            stop = guard.should_stop
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
