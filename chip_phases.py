"""Run chosen phases of a checkout's ``chip_smoke.py`` on one card.

    python3 chip_phases.py [--root DIR] PHASE [PHASE ...]

PHASE is one of 10 to 16 (the mask producers, training, the recurrent
and encoder-decoder producers, the DeepSeek family, the mesh: the
dry-run, the MaskSearch cells and every family's sharded steps and
checkpoint on a one-card mesh; codeqwen1.5-7b, qwen3-32b, gemma3-27b
and internvl2-1b; the paper's quickstart and scenarios 2-6).  The
script loads ``DIR/chip_smoke.py`` (default: the checkout beside this
script) with ``DIR/src`` on the path, builds that checkout's kernels, and
calls the phases' functions as ``chip_smoke.py`` does, so they print
their usual lines.  To compare two commits on one card, unpack one of
them (``git archive``) into a directory that ``.gitignore`` lists and run
this script in one call for each, in the order parent, change, change,
parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

PHASES = {10: "producer_phase", 11: "training_phase", 12: "other_phase",
          13: "deepseek_phase", 14: "mesh_phase14", 15: "dense_phase",
          16: "examples_phase"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("phases", nargs="+", type=int, choices=sorted(PHASES))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import cuda_lib, ops
    cuda_lib.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"chip_phases: {root} ({smi})")
    for p in args.phases:
        t0 = time.perf_counter()
        dev = torch.device("cuda")
        # phase 14 takes the kernels' launch counters too, phase 16 only
        # them
        args = {14: (torch, dev, ops, smi), 16: (torch, ops, smi)}.get(
            p, (torch, dev, smi))
        getattr(smoke, PHASES[p])(*args)
        print(f"chip_phases: phase {p} {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
