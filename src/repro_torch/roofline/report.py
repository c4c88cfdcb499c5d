"""Render the port's dry-run result JSONs into two markdown tables.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir dryrun_results]

The port of the JAX package's ``roofline/report.py``.  Produces on stdout:
  §Dry-run  — status + reckoned bytes/rank + collective schedule, both
              meshes, every cell;
  §Roofline — the three per-rank time terms on the NVIDIA H100 constants
              (launch/mesh.py), dominant bottleneck, MODEL_FLOPS/counted
              FLOPs useful ratio (single-pod cells).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from ..launch.mesh import PEAK_FLOPS_BF16


def load_results(dir_: str, mesh: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_, mesh, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def _fmt_bytes(b) -> str:
    return f"{b / 1e9:.2f}"


def dryrun_table(results: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | peak GB/dev | fits 80G | "
        "collectives (AG/AR/RS/A2A/CP) | build s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"SKIP ({r['reason'][:60]}…) | – | – | – | – |")
            continue
        if r["status"] == "failed":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"**FAIL** {r['error'][:60]} | – | – | – | – |")
            continue
        cost = r.get("linearized_cost") or r.get("scanned_cost") or r.get("cost")
        cc = cost["coll_counts"] if cost else {}
        colls = "/".join(str(int(cc.get(k, 0))) for k in
                         ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute"))
        mem = r["memory"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
            f"{_fmt_bytes(mem['peak_estimate_bytes'])} | "
            f"{'✔' if r.get('fits_80g') else '✘'} | {colls} | "
            f"{r.get('lower_s', 0):.1f} |")
    return "\n".join(lines)


def roofline_table(results: list[dict]) -> str:
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms | dominant |"
        " MODEL_TFLOPs | useful ratio | roofline fraction |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        roof = r.get("roofline")
        if not roof or r["status"] != "ok":
            continue
        bound = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
        # roofline fraction: useful model FLOPs per rank-second at the pace
        # the dominant term allows, vs the H100's bf16 peak
        n_chips = r.get("n_chips", 256)
        if roof["model_flops"] > 0 and bound > 0:
            frac = (roof["model_flops"] / n_chips / bound) / PEAK_FLOPS_BF16
        else:
            frac = 0.0
        # clamp for display (a 1g/2g delta can go below zero)
        comp = max(roof['compute_s'], 0.0)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {comp * 1e3:.2f} | "
            f"{roof['memory_s'] * 1e3:.2f} | {roof['collective_s'] * 1e3:.2f} | "
            f"{roof['dominant']} | {roof['model_flops'] / 1e12:.0f} | "
            f"{max(roof['useful_ratio'], 0.0):.2f} | {frac:.1%} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="dryrun_results")
    args = ap.parse_args()

    single = load_results(args.dir, "single")
    multi = load_results(args.dir, "multi")
    print("## §Dry-run (single-pod 16x16 = 256 ranks)\n")
    print(dryrun_table(single))
    if multi:
        print("\n## §Dry-run (multi-pod 2x16x16 = 512 ranks)\n")
        print(dryrun_table(multi))
    print("\n## §Roofline (single-pod, per-rank terms on the H100; "
          "1g/2g linearization)\n")
    print(roofline_table(single))
    n_ok = sum(r["status"] == "ok" for r in single)
    n_skip = sum(r["status"] == "skipped" for r in single)
    n_fail = sum(r["status"] == "failed" for r in single)
    print(f"\nsingle-pod: {n_ok} ok / {n_skip} skip / {n_fail} fail")
    if multi:
        n_ok = sum(r["status"] == "ok" for r in multi)
        n_skip = sum(r["status"] == "skipped" for r in multi)
        n_fail = sum(r["status"] == "failed" for r in multi)
        print(f"multi-pod:  {n_ok} ok / {n_skip} skip / {n_fail} fail")


if __name__ == "__main__":
    main()
