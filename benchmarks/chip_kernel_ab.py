#!/usr/bin/env python3
"""A/B timings of the CHI and multi-descriptor CP kernels on one GPU.

    python3 benchmarks/chip_kernel_ab.py

Each variant is the shipped source of ``csrc/chi_build.cu`` or
``csrc/cp_count.cu`` with one design choice undone by a text edit, built
with the package's ``nvcc`` flags into ``kernels/_build/ab/`` and called
through the shipped launcher on the inputs of the main path: 2,048
saliency masks of 224x224 (an ingest chunk) and their binarisation for the
CHI kernel, one descriptor over 3,861 object-box ROIs of 4,096 resident
masks for the CP kernel.  A small batch of each (64 masks; 170 ROIs) times
the block-per-mask grid against the banded CHI grid the wrapper picks for
it, and against CP blocks that split a mask's rows.  Every variant's answer is held to the plain version (tolerance 0)
and timed with ``chip_smoke.time_ms``.  Prints one line per variant, the
bytes the CP call's ROI rows span in whole 32- and 64-byte pieces, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

H = W = 224
N_CHI = 2048
N_RESIDENT, N_VERIFY = 4096, 3861

CHI_VARIANTS = {
    "shipped": [],
    # 15 compares a pixel instead of the 4-step search
    "linear bins": [("    pos += (e[pos + s - 1] <= x) ? s : 0;\n"
                     "  return min(pos, n_edges);",
                     "    ;\n  for (int k = 0; k < n_edges; ++k) "
                     "pos += e[k] <= x;\n  return pos;")],
    # equal (cell, bin) keys among a thread's four pixels add once
    "merge equal keys": [(
        "  for (int i = 0; i < 4; ++i) atomicAdd(hist + key[i], 1);",
        "  for (int i = 0; i < 4; ++i) {\n"
        "    bool first = true;\n    int n = 1;\n"
        "#pragma unroll\n    for (int j = 0; j < 4; ++j) {\n"
        "      if (j < i) first &= key[j] != key[i];\n"
        "      if (j > i) n += key[j] == key[i];\n    }\n"
        "    if (first) atomicAdd(hist + key[i], n);\n  }")],
    # four rows' 16-byte loads in flight per thread
    "four loads in flight": [(
        "      for (; r < r1; r += rps, off += stride) {\n        float v[4];",
        "      for (; r + 3 * rps < r1; r += 4 * rps, off += 4 * stride) {\n"
        "        float v[4][4];\n#pragma unroll\n"
        "        for (int u = 0; u < 4; ++u) "
        "load_vec(m + off + u * stride, v[u]);\n"
        "#pragma unroll\n        for (int u = 0; u < 4; ++u) {\n"
        "          const int rk = row_key[r + u * rps - r0];\n"
        "          int key[4];\n#pragma unroll\n"
        "          for (int i = 0; i < 4; ++i)\n"
        "            key[i] = rk + ck[i] + "
        "bin_of<LOGP>(edge, n_edges, v[u][i]);\n"
        "          add4(hist, key);\n        }\n      }\n"
        "      for (; r < r1; r += rps, off += stride) {\n        float v[4];")],
}
CP_VARIANTS = {
    "shipped": [],
    "one load in flight": [("constexpr int U = QB <= 2 ? 4 : 2;",
                            "constexpr int U = 1;")],
    "eight loads in flight": [("constexpr int U = QB <= 2 ? 4 : 2;",
                               "constexpr int U = QB <= 2 ? 8 : 2;")],
    # 128-thread blocks: twice the blocks in flight, half the lanes a mask
    "128 threads": [("<<<grid, kThreads, 0, s>>>", "<<<grid, 128, 0, s>>>")],
    "64 threads": [("<<<grid, kThreads, 0, s>>>", "<<<grid, 64, 0, s>>>")],
    # a mask's union rows split over four blocks, which add into a zeroed
    # output
    "rows split over 4 blocks": [
        ("    int cnt[QB];\n",
         "    {\n      const int nr = max(ur1 - ur0, 0), s0 = ur0;\n"
         "      ur0 = s0 + nr * (int)blockIdx.y / 4;\n"
         "      ur1 = s0 + nr * ((int)blockIdx.y + 1) / 4;\n    }\n"
         "    int cnt[QB];\n"),
        ("      out[(size_t)(g0 + threadIdx.x) * B + b] = sum;",
         "      atomicAdd(out + (size_t)(g0 + threadIdx.x) * B + b, sum);"),
        ("const dim3 grid(B, 1);", "const dim3 grid(B, 4);")],
}


def build(name: str, variants: dict) -> dict:
    from repro_torch.kernels import cuda_lib
    out_dir = cuda_lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cuda_lib.CSRC / f"{name}.cu").read_text()
    procs = {}
    for label, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {label!r}: {old!r} not in {name}.cu")
            text = text.replace(old, new)
        stem = f"{name}-{label.replace(' ', '_')}"
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{stem}.so"
        procs[label] = (subprocess.Popen(
            [cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def sector_bytes(rois: np.ndarray, itemsize: int, sector: int) -> int:
    """Bytes of the whole ``sector``-byte pieces that the ROI rows touch:
    what the memory system moves for short row segments."""
    r0, c0, r1, c1 = (rois[:, i].astype(np.int64) for i in range(4))
    per_row = ((c1 * itemsize + sector - 1) // sector -
               (c0 * itemsize) // sector) * sector
    return int(((r1 - r0) * per_row).sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import PEAK_BYTES_S, bound_of, time_ms
    from repro_torch.data import masks as masks_mod
    from repro_torch.kernels import chi_build, cp_count, cuda_lib, ops, ref
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    stream = cuda_lib.stream(dev)
    boxes = masks_mod.object_boxes(N_RESIDENT, H, W, seed=1)
    host, _ = masks_mod.saliency_masks(N_RESIDENT, H, W, seed=0,
                                       attacked_fraction=0.15, boxes=boxes)
    resident = torch.from_numpy(host).to(dev)
    del host

    # -- chi_cell_hist: an ingest chunk, float and binary; a small batch ---
    edges = torch.arange(1, 16, dtype=torch.float32) / 16
    d_edges = edges.to(dev)
    rb = chi_build._bounds_on(dev, H, 16)
    cb = chi_build._bounds_on(dev, W, 16)
    cases = [("float", resident[:N_CHI]),
             ("binary", (resident[:N_CHI] > 0.5).float()),
             ("64-mask batch", resident[:64])]
    for label, lib in build("chi_build", CHI_VARIANTS).items():
        lib.chi_cell_hist_launch.argtypes = [P] * 4 + [I] * 7 + [P, P]
        for kind, m in cases:
            b = m.shape[0]
            want = ref.chi_cell_hist_ref(m, edges, 16)
            bound, _ = bound_of(torch, ref, "chi_cell_hist", (m, edges, 16))
            # band = cell rows per block: 16 is a block per mask, 1 is
            # the grid of a block per (mask, cell row)
            bands = {16, chi_build.cell_rows_per_block(b, H, W, 16, 16, dev)}
            if label == "shipped":
                bands.add(1)
            elif b != N_CHI:
                continue
            for band in sorted(bands, reverse=True):
                out = torch.empty_like(want)

                def run(lib=lib, m=m, band=band, out=out):
                    rc = lib.chi_cell_hist_launch(
                        m.data_ptr(), d_edges.data_ptr(), rb.data_ptr(),
                        cb.data_ptr(), m.shape[0], H, W, 16, 16, band, 1,
                        out.data_ptr(), stream)
                    cuda_lib.check(rc, "chi_cell_hist")
                run()
                if not torch.equal(out, want):
                    raise SystemExit(f"chi variant {label} differs")
                ms = time_ms(torch, run)
                print(f"ab chi_cell_hist {kind} {label}, {band} cell rows a "
                      f"block: {ms:.4f} ms, bound {bound:.4f} ms, "
                      f"{ms / bound:.2f}x")
    del cases

    # -- cp_count_multi: one descriptor over a verification batch, and a
    # small one -------------------------------------------------------------
    rng = np.random.default_rng(2)
    thr = cp_count.thresholds([0.8], [1.0], torch.float32).to(dev)
    batches = {}
    for b in (N_VERIFY, 170):
        pos = np.sort(rng.choice(N_RESIDENT, b, replace=False))
        rois = boxes[pos]
        px = int(((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])).sum())
        print(f"ab cp_count_multi {b}-mask batch: ROI bytes {4 * px}, in "
              f"32-byte sectors {sector_bytes(rois, 4, 32)}, in 64-byte "
              f"pieces {sector_bytes(rois, 4, 64)}; the sector bytes over "
              f"the HBM rate "
              f"{sector_bytes(rois, 4, 32) / PEAK_BYTES_S * 1e3:.4f} ms")
        batches[b] = (torch.from_numpy(pos).to(dev),
                      torch.from_numpy(rois[None]).to(dev))
    for label, lib in build("cp_count", CP_VARIANTS).items():
        lib.cp_count_multi_launch.argtypes = [P, I, P, L, P, P] + [I] * 5 + \
            [P, P]
        for b, (pos, rois) in batches.items():
            want = ref.cp_count_multi_ref(resident, rois, [0.8], [1.0], pos)
            bound, _ = bound_of(torch, ref, "cp_count_multi",
                                (resident, rois, [0.8], [1.0], pos))
            gathered = resident[pos]
            zero = label.startswith("rows split")
            for how in ("indexed", "gathered"):
                if how == "gathered" and b != N_VERIFY:
                    continue
                src, p, n = (resident, pos.data_ptr(), N_RESIDENT) \
                    if how == "indexed" else (gathered, None, b)
                out = torch.zeros_like(want)

                def run(lib=lib, src=src, p=p, n=n, b=b, out=out, rois=rois):
                    if zero:
                        out.zero_()
                    rc = lib.cp_count_multi_launch(
                        src.data_ptr(), 0, p, n, rois.data_ptr(),
                        thr.data_ptr(), 1, b, H, W, 1, out.data_ptr(), stream)
                    cuda_lib.check(rc, "cp_count_multi")
                run()
                if not torch.equal(out, want):
                    raise SystemExit(f"cp variant {label} differs")
                ms = time_ms(torch, run)
                print(f"ab cp_count_multi {b}-mask batch {label}, {how}: "
                      f"{ms:.4f} ms, bound {bound:.4f} ms, {ms / bound:.2f}x")
    pos, rois = batches[N_VERIFY]
    lv, uv = np.float32([0.8]), np.float32([1.0])
    wrap = time_ms(torch, lambda: ops.cp_count_multi(resident, rois, lv, uv,
                                                     pos))
    print(f"ab cp_count_multi shipped, indexed, through the wrapper (host "
          f"thresholds, one pinned copy): {wrap:.4f} ms")
    step = time_ms(torch, lambda: ops.cp_count_multi(resident[pos], rois, lv,
                                                     uv))
    print(f"ab cp_count_multi shipped, gather + kernel through the wrapper: "
          f"{step:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
