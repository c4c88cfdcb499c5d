#!/usr/bin/env python3
"""A/B timings of the CHI, multi-descriptor CP (float and packed),
bounds+verify and packed pair kernels on one GPU.

    python3 benchmarks/chip_kernel_ab.py [--popcount]

Each variant is the shipped source of ``csrc/chi_build.cu``,
``csrc/cp_count.cu`` or ``csrc/popcount.cu`` with one design choice undone
by a text edit, built with the package's ``nvcc`` flags into
``kernels/_build/ab/`` and called through the shipped launcher on the
inputs of the main path: 2,048 saliency masks of 224x224 (an ingest chunk)
and their binarisation for the CHI kernel, one descriptor over 3,861
object-box ROIs of 4,096 resident masks for the CP kernel.  A small batch
of each (64 masks; 170 ROIs) times the block-per-mask grid against the
banded CHI grid the wrapper picks for it, and against CP blocks that split
a mask's rows.  The popcount kernels run on the binarised resident masks
(``> 0.5``, packed): the megakernel on 708 of them, as the packed filter's
verification batch, with one object-box descriptor and none decided, then
with three descriptors and half the masks' entries all decided; the
packed multi-descriptor kernel on 4,096 of 16,384 resident planes (the
4,096 masks four times; every fourth plane, as the smoke's fused pass
takes every sixteenth of 65,536), with the scheduler pass's 8 descriptors
and with its first alone, indexed and gathered: the shipped block per
mask over staged rows (capped at 32 registers) against the first body's
warp per mask, direct loads and no register cap, each timed four times
in turns; the pair kernel on the pair store's layout (image i as planes
2i and 2i + 1 of 16,384 resident planes, ``object_boxes(seed=4)`` as the
smoke's pair boxes), 8,192 images gathered as on the naive scan and indexed, and a
1,115-image device round: the shipped word-column body (capped at 32
registers), the same without the cap, and a body streaming the box's row
span in 16-byte vectors, each timed four times in turns.  Every
variant's answer is held to the plain version (tolerance 0) and timed with
``chip_smoke.time_ms``.  Prints one line per variant, the
bytes the CP call's ROI rows span in whole 32- and 64-byte pieces, the
popcount calls' bounds and sector floors, the launch floor, the megakernel's
time behind pinned copies of 8 B to 64 KB and with its operands read from
pinned host memory, where its wrapper's host time goes (each piece on the
host clock, against the step as the device backend runs it, with its copy
back), and the card's name and power limit.  With ``--popcount`` only
the popcount kernels' part runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

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


# The Q-descriptor kernels' rows read from device memory, none staged.
DIRECT_LOADS = ("  const int staged = plane_bytes <= (size_t)kStageBytes;",
                "  const int staged = 0;")
# The first grid of the megakernel: a warp per mask, its descriptors one
# after another, each from device memory.
WARP_PER_MASK = """
__global__ void __launch_bounds__(kWarps * 32)
fused_verify_warp_kern(const unsigned* __restrict__ words,
                       const long long* __restrict__ positions, long long N,
                       const int* __restrict__ flags,
                       const int* __restrict__ rois,
                       const int* __restrict__ decided,
                       const int* __restrict__ lb, int Q, int B, int H,
                       int nw, int* __restrict__ out) {
  const int b = warp_item();
  if (b >= B) return;
  const unsigned* m = plane_of(words, positions, N, b, (size_t)H * nw);
  for (int q = 0; q < Q; ++q) {
    const size_t i = (size_t)q * B + b;
    if (decided[i]) {
      if ((threadIdx.x & 31) == 0) out[i] = lb[i];
      continue;
    }
    const int c = cp_desc_count(m, H, nw, rois + 4 * i, flags[2 * q],
                                flags[2 * q + 1]);
    if ((threadIdx.x & 31) == 0) out[i] = c;
  }
}

// No work: its launch is the floor"""
FUSED_VARIANTS = {
    "shipped": [],
    "warp per mask (first grid)": [
        ("\n// No work: its launch is the floor", WARP_PER_MASK),
        ("  fused_verify_kern<<<B, kBlockThreads, st.smem,\n"
         "                      static_cast<cudaStream_t>(stream)>>>(",
         "  fused_verify_warp_kern<<<blocks_for(B), kWarps * 32, 0,\n"
         "                      static_cast<cudaStream_t>(stream)>>>("),
        ("static_cast<const int*>(lb), Q, B, H,\n"
         "      nw, st.staged, st.vec, static_cast<int*>(out));",
         "static_cast<const int*>(lb), Q, B, H,\n"
         "      nw, static_cast<int*>(out));")],
    # every descriptor counted from device memory, no shared copy
    "direct loads": [DIRECT_LOADS],
    # a mask whose entries are all decided still stages its rows
    "no skip of all-decided masks": [("    if (counted && !dec) {",
                                      "    if (counted) {")],
}
# The first cp_count_multi_packed body: a warp per mask, its descriptors
# one after another, each re-walking the rows from L1 with its own
# reduction (here reading through positions, as the shipped kernel does).
WARP_PER_MASK_MULTI = """
__global__ void __launch_bounds__(kWarps * 32)
cp_multi_warp_kern(const unsigned* __restrict__ words,
                   const long long* __restrict__ positions, long long N,
                   const int* __restrict__ flags,
                   const int* __restrict__ rois, int Q, int B, int H,
                   int nw, int* __restrict__ out) {
  const int b = warp_item();
  if (b >= B) return;
  const unsigned* m = plane_of(words, positions, N, b, (size_t)H * nw);
  for (int q = 0; q < Q; ++q) {
    const size_t i = (size_t)q * B + b;
    const int c = cp_desc_count(m, H, nw, rois + 4 * i, flags[2 * q],
                                flags[2 * q + 1]);
    if ((threadIdx.x & 31) == 0) out[i] = c;
  }
}

// No work: its launch is the floor"""
MULTI_VARIANTS = {
    "shipped": [],
    "warp per mask (first body)": [
        ("\n// No work: its launch is the floor", WARP_PER_MASK_MULTI),
        ("  cp_multi_block_kern<<<B, kBlockThreads, st.smem,\n"
         "                        static_cast<cudaStream_t>(stream)>>>(",
         "  cp_multi_warp_kern<<<blocks_for(B), kWarps * 32, 0,\n"
         "                        static_cast<cudaStream_t>(stream)>>>("),
        ("static_cast<const int*>(rois), Q, B, H,\n"
         "      nw, st.staged, st.vec, static_cast<int*>(out));",
         "static_cast<const int*>(rois), Q, B, H,\n"
         "      nw, static_cast<int*>(out));")],
    "direct loads": [DIRECT_LOADS],
    # no floor of 16 blocks of 128 threads an SM (the shipped cap)
    "no register cap": [
        ("__launch_bounds__(kBlockThreads, 16)\ncp_multi_block_kern",
         "__launch_bounds__(kBlockThreads)\ncp_multi_block_kern")],
}
# A pair body that streams the box's whole row span with 16-byte loads
# (every fetched sector used whole, span masks from a per-warp table),
# tried against the shipped word-column body and not shipped.
PAIR_COLUMNS = ("  if (r.area() > 0) {  // lanes on the box's word columns, "
                "two rows a step")
VECTOR_BODY = """  if (r.area() > 0 && (uintptr_t)ma % 16 == 0 &&
      (uintptr_t)mb % 16 == 0 && plane % 4 == 0 && nw <= 64) {
    __shared__ unsigned span_tab[kWarps][64];
    unsigned* tab = span_tab[threadIdx.x >> 5];
    const int lane = threadIdx.x & 31;
    for (int k = lane; k < nw; k += 32) tab[k] = span_mask(r.c0, r.c1, k);
    __syncwarp();
    auto add = [&](unsigned a, unsigned b, unsigned span) {
      const unsigned ea = (a & keep_a) | (~a & flip_a);
      const unsigned eb = (b & keep_b) | (~b & flip_b);
      ci += __popc(ea & eb & span);
      cu += __popc((ea | eb) & span);
      cd += __popc(ea & ~eb & span);
    };
    const int k0 = r.c0 >> 5, k1 = (r.c1 + 31) >> 5;
    const int s1 = ((r.r1 - 1) * nw + k1 + 3) & ~3;
    int i = ((r.r0 * nw + k0) & ~3) + 4 * lane;
    int row = i / nw, col = i - row * nw;
    const int drow = 128 / nw, dcol = 128 % nw;
    for (; i < s1; i += 256) {
      const bool two = i + 128 < s1;
      const uint4 a0 = __ldg(reinterpret_cast<const uint4*>(ma + i));
      const uint4 b0 = __ldg(reinterpret_cast<const uint4*>(mb + i));
      uint4 a1 = make_uint4(0, 0, 0, 0), b1 = a1;
      if (two) {
        a1 = __ldg(reinterpret_cast<const uint4*>(ma + i + 128));
        b1 = __ldg(reinterpret_cast<const uint4*>(mb + i + 128));
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (v == 1 && !two) break;
        const uint4 a = v ? a1 : a0, bb = v ? b1 : b0;
        const unsigned wa[4] = {a.x, a.y, a.z, a.w};
        const unsigned wb[4] = {bb.x, bb.y, bb.z, bb.w};
        int rr = row, cc = col;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          add(wa[u], wb[u], (rr >= r.r0 && rr < r.r1) ? tab[cc] : 0u);
          if (++cc == nw) {
            cc = 0;
            ++rr;
          }
        }
        row += drow;
        col += dcol;
        if (col >= nw) {
          col -= nw;
          ++row;
        }
      }
    }
  } else""" + PAIR_COLUMNS[1:]
# no floor of 8 blocks an SM: the compiler's own register count
UNCAPPED = ("__launch_bounds__(kWarps * 32, 8)\npair_packed_kern",
            "__launch_bounds__(kWarps * 32)\npair_packed_kern")
PAIR_VARIANTS = {
    "shipped": [],
    # its own registers: under the shipped cap of 32 it spills
    "vector streaming body": [(PAIR_COLUMNS, VECTOR_BODY), UNCAPPED],
    "no register cap": [UNCAPPED],
}
N_FUSED, N_PAIRS = 708, 8192


def build(name: str, variants: dict, logs: dict | None = None) -> dict:
    """Each variant of ``csrc/<name>.cu`` (every occurrence of each edit's
    text replaced) built and loaded; ``logs`` receives each variant's ptxas
    report."""
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
        if logs is not None:
            logs[label] = log
    return libs


def registers(log: str, kernel: str) -> str:
    """The ptxas "Used N registers" report of ``kernel`` in a build log."""
    found = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = kernel in line
        elif found and "Used" in line:
            return line.split("info    :")[-1].strip()
    return "not reported"


def in_turns(torch, calls: dict) -> dict:
    """Each call timed four times (``chip_smoke.time_ms``), in turns: every
    call, then again in reverse order, twice → label: list of ms."""
    from chip_smoke import time_ms
    runs = {label: [] for label in calls}
    for label in (list(calls) + list(calls)[::-1]) * 2:
        runs[label].append(time_ms(torch, calls[label]))
    return runs


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
    if sys.argv[1:] == ["--popcount"]:  # the popcount kernels' part only
        popcount_ab(torch, (resident > 0.5).cpu().numpy(), boxes, stream)
        return 0

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
    popcount_ab(torch, (resident > 0.5).cpu().numpy(), boxes, stream)
    return 0


def host_ms(torch, fn, reps=2000, warmup=50) -> float:
    """Mean host-clock time of ``fn`` over ``reps`` back-to-back calls, the
    card drained before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def fused_host_breakdown(torch, words, pos, case, rng) -> None:
    """Where the megakernel wrapper's host time goes on the packed filter's
    batch (Q=1, 708 masks, none decided): each piece of
    ``fused_bounds_verify_cuda`` alone on the host clock, the whole
    wrapper, the step as the device backend runs it (the wrapper, then the
    (Q, B) counts copied to the host, which waits for the card), and an
    empty launch with the same copy back as its floor."""
    from repro_torch.kernels import cuda_lib, ops, popcount, ref
    rois, lvs, uvs, dec = case
    rois = rois.astype(np.int32)
    lvs, uvs = np.float32(lvs), np.float32(uvs)
    lb = rng.integers(0, 1000, dec.shape).astype(np.int32)
    args = (words, rois, lvs, uvs, dec, lb, pos)
    q, b = dec.shape
    dev = words.device
    flags = popcount._flags(lvs, uvs)
    parts = [pos, flags, rois, dec, lb]
    card, (pos_addr, *addr) = cuda_lib.stage(parts, dev)
    small = torch.zeros((q, b), dtype=torch.int32, device=dev)
    pieces = {
        "range flags": lambda: popcount._flags(lvs, uvs),
        "operand checks": lambda: (
            popcount._host_rows(rois, np.int32, (q, b, 4), "rois"),
            popcount._host_rows(dec, np.int32, (q, b), "decided") != 0,
            popcount._host_rows(lb, np.int32, (q, b), "lb")),
        "pinned buffer": lambda: torch.empty(
            sum(p.size for p in parts) + b, dtype=torch.int32,
            pin_memory=True),
        "stage (pinned buffer + concatenate + copy)": lambda: (
            cuda_lib.stage(parts, dev)),
        "launch (output + ctypes)": lambda: popcount._fused_launch(
            words, q, b, *addr, pos_addr),
        "whole wrapper": lambda: ops.fused_bounds_verify(*args),
        "wrapper + copy back (the device step)": lambda: (
            ops.fused_bounds_verify(*args).cpu().numpy()),
        "empty launch + copy back": lambda: (
            popcount.empty_launch(dev), small.cpu().numpy()),
    }
    want = ref.fused_bounds_verify_ref(*args)
    if not torch.equal(ops.fused_bounds_verify(*args), want):
        raise SystemExit("fused wrapper differs")
    times = {label: host_ms(torch, fn) for label, fn in pieces.items()}
    del card
    print("ab fused_bounds_verify Q=1, host clock per call (ms): " +
          "; ".join(f"{label} {t:.4f}" for label, t in times.items()))


def popcount_ab(torch, binary, boxes, stream) -> None:
    """The megakernel's and the packed pair kernel's variants on the
    binarised resident masks."""
    from chip_smoke import (card_popcount_rate, packed_bound_of,
                            pair_bound_of, time_ms)
    from repro_torch.core.packing import pack_masks
    from repro_torch.data import masks as masks_mod
    from repro_torch.kernels import cuda_lib, ops, popcount, ref
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    words = torch.from_numpy(pack_masks(binary).view(np.int32)).to(dev)
    n, h, nw = words.shape
    rate = card_popcount_rate(torch)
    floor = time_ms(torch, lambda: popcount.empty_launch(dev))
    print(f"ab launch floor (empty kernel): {floor:.4f} ms")

    # -- fused_bounds_verify: the packed filter's batch, then three
    # descriptors with half the masks' entries all decided
    rng = np.random.default_rng(3)
    pos = np.sort(rng.choice(n, N_FUSED, replace=False))
    half = rng.random(N_FUSED) < 0.5
    cases = {
        "Q=1, none decided": (boxes[pos][None], [0.5], [1.5],
                              np.zeros((1, N_FUSED), np.int32)),
        "Q=3, half the masks all decided": (
            np.stack([boxes[pos], np.tile([0, 0, h, 224], (N_FUSED, 1)),
                      np.tile([3, 5, 221, 223], (N_FUSED, 1))]),
            [0.5, 0.5, 0.0], [1.5, 1.5, 1.0],
            np.tile(half, (3, 1)).astype(np.int32))}
    pos_d = torch.from_numpy(pos).to(dev)
    inputs = {}
    for label, (rois, lvs, uvs, dec) in cases.items():
        rois = rois.astype(np.int32)
        lvs, uvs = np.float32(lvs), np.float32(uvs)
        lb = rng.integers(0, 1000, dec.shape).astype(np.int32)
        args = (words, rois, lvs, uvs, dec, lb, pos)
        want = ref.fused_bounds_verify_ref(*args)
        bound, _, sector = packed_bound_of(
            torch, ref, "fused_bounds_verify", (words[pos_d],) + args[1:6],
            rate)
        wrap = time_ms(torch, lambda a=args: ops.fused_bounds_verify(*a))
        flags = ref._range_flags(lvs, uvs).reshape(-1, 2)
        # the operands read by the kernel straight from pinned host memory
        # (device-visible under unified addressing): one device operation a
        # call, no copy
        pinned = [torch.from_numpy(x).pin_memory() for x in
                  (flags, rois, dec, lb, pos)]
        zero = time_ms(torch, lambda h=pinned, q=dec.shape[0]: (
            popcount._fused_launch(words, q, N_FUSED,
                                   *(t.data_ptr() for t in h))))
        torch.cuda.synchronize()
        if not torch.equal(popcount._fused_launch(
                words, dec.shape[0], N_FUSED,
                *(t.data_ptr() for t in pinned)), want):
            raise SystemExit("fused zero-copy read differs")
        print(f"ab fused_bounds_verify {label}: bound {bound:.4f} ms, sector "
              f"floor {sector:.4f} ms; shipped through the wrapper (one "
              f"staged copy) {wrap:.4f} ms; the kernel reading its operands "
              f"from pinned host memory {zero:.4f} ms")
        inputs[label] = (want, bound, [torch.from_numpy(x).to(dev) for x in
                                       (flags, rois, dec, lb)])
    for label, lib in build("popcount", FUSED_VARIANTS).items():
        lib.fused_verify_launch.argtypes = [P, P, L, P, P, P, P, I, I, I, I,
                                            P, P]
        for case, (want, bound, (fl, ro, de, lb)) in inputs.items():
            q, b = de.shape
            out = torch.empty_like(want)

            def run(lib=lib, fl=fl, ro=ro, de=de, lb=lb, out=out, q=q, b=b):
                rc = lib.fused_verify_launch(
                    words.data_ptr(), pos_d.data_ptr(), n, fl.data_ptr(),
                    ro.data_ptr(), de.data_ptr(), lb.data_ptr(), q, b, h, nw,
                    out.data_ptr(), stream)
                cuda_lib.check(rc, "fused_bounds_verify")
            run()
            if not torch.equal(out, want):
                raise SystemExit(f"fused variant {label} differs")
            ms = time_ms(torch, run)
            print(f"ab fused_bounds_verify {case}, {label}, indexed: "
                  f"{ms:.4f} ms, bound {bound:.4f} ms, {ms / bound:.2f}x")

    fused_host_breakdown(torch, words, pos, cases["Q=1, none decided"], rng)

    # the staged copy's size against the device time of copy + kernel (the
    # kernel on the Q=1 operands already on the card)
    _, _, (fl, ro, de, lb) = inputs["Q=1, none decided"]
    for nbytes in (8, 1024, 4096, 16384, 22656, 65536):
        src = torch.zeros(nbytes // 4, dtype=torch.int32).pin_memory()
        dst = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)

        def run(src=src, dst=dst):
            dst.copy_(src, non_blocking=True)
            popcount.fused_verify_launch(words, fl, ro, de, lb, pos_d)
        print(f"ab fused_bounds_verify Q=1, a {nbytes}-byte pinned copy + "
              f"the kernel: {time_ms(torch, run):.4f} ms")

    # 16,384 resident planes: the 4,096 masks four times, 103 MB, past the
    # 50 MB L2 as the smoke's stores
    big = words.repeat(4, 1, 1)
    multi_packed_ab(torch, big, boxes, rate, stream)

    # -- pair_counts_packed in the pair store's layout: image i is planes
    # (2i, 2i + 1) of the 16,384 resident planes, all 8,192 images gathered
    # as on the naive scan and indexed, and a 1,115-image device round
    boxes = masks_mod.object_boxes(N_PAIRS, h, 224, seed=4)
    f1, f0 = ref._thresh_flags(0.6)
    calls = {}
    for label, imgs in (("8,192 pairs", np.arange(N_PAIRS)),
                        ("1,115-pair round",
                         np.sort(rng.choice(N_PAIRS, 1115, replace=False)))):
        pa = torch.from_numpy(2 * imgs).to(dev)
        pb = pa + 1
        rois = torch.from_numpy(boxes[imgs]).to(dev)
        ga, gb = big[pa], big[pb]
        want = torch.stack(ref.pair_counts_packed_ref(ga, gb, rois, 0.6,
                                                      0.6))
        bound, _, sector = pair_bound_of(torch, ref, "pair_counts_packed",
                                         (ga, gb, rois, 0.6, 0.6), rate)
        print(f"ab pair_counts_packed {label}: bound {bound:.4f} ms, sector "
              f"floor {sector:.4f} ms")
        calls[f"{label}, indexed"] = (big, big, pa, pb, rois, want, bound,
                                      sector)
        if len(imgs) == N_PAIRS:
            calls[f"{label}, gathered"] = (ga, gb, None, None, rois, want,
                                           bound, sector)
    libs = build("popcount", PAIR_VARIANTS)
    for lib in libs.values():
        lib.pair_packed_launch.argtypes = [P, P, L, P, P, L, P] + [I] * 7 + \
            [P, P]
    for case, (a, b, p_a, p_b, rois, want, bound, sector) in calls.items():
        runs = {}
        for label, lib in libs.items():
            out = torch.empty_like(want)

            def run(lib=lib, a=a, b=b, p_a=p_a, p_b=p_b, rois=rois, out=out):
                rc = lib.pair_packed_launch(
                    a.data_ptr(), None if p_a is None else p_a.data_ptr(),
                    a.shape[0], b.data_ptr(),
                    None if p_b is None else p_b.data_ptr(), b.shape[0],
                    rois.data_ptr(), f1, f0, f1, f0, rois.shape[0], h, nw,
                    out.data_ptr(), stream)
                cuda_lib.check(rc, "pair_counts_packed")
            run()
            if not torch.equal(out, want):
                raise SystemExit(f"pair variant {label} differs")
            runs[label] = run
        for label, ms in in_turns(torch, runs).items():
            mean = sum(ms) / len(ms)
            print(f"ab pair_counts_packed {case}, {label}: {mean:.4f} ms "
                  f"(runs {', '.join(f'{t:.4f}' for t in ms)}), bound "
                  f"{bound:.4f} ms, {mean / bound:.2f}x, sector floor "
                  f"{mean / sector:.2f}x")


def multi_packed_ab(torch, big, boxes, rate, stream) -> None:
    """The packed multi-descriptor kernel's variants on 4,096 of the
    resident planes ``big`` (every fourth), with the scheduler pass's 8
    descriptors and with its first alone, indexed and gathered; and the
    shipped kernel through its wrapper, indexed, against the gather the
    device step ran before."""
    from chip_smoke import fused_specs, packed_bound_of, time_ms
    from repro_torch.core.backend import spec_arrays
    from repro_torch.kernels import cuda_lib, ops, ref
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = big.device
    n, h, nw = big.shape
    pos = np.arange(0, n, 4)[:N_RESIDENT]
    pos_d = torch.from_numpy(pos).to(dev)
    gathered = big[pos_d]
    rois_q, lvs, uvs = spec_arrays(fused_specs(boxes[pos % len(boxes)]))
    cases = {}
    for q in (8, 1):
        rq, lq, uq = rois_q[:q], lvs[:q], uvs[:q]
        want = ref.cp_count_multi_packed_ref(gathered, rq, lq, uq)
        bound, _, sector = packed_bound_of(
            torch, ref, "cp_count_multi_packed", (gathered, rq, lq, uq), rate)
        fl = torch.from_numpy(ref._range_flags(lq, uq).reshape(-1, 2)).to(dev)
        ro = torch.from_numpy(rq).to(dev)
        wrap = time_ms(torch, lambda rq=rq, lq=lq, uq=uq: (
            ops.cp_count_multi_packed(big, rq, lq, uq, pos)))
        old = time_ms(torch, lambda ro=ro, lq=lq, uq=uq: (
            ops.cp_count_multi_packed(big.index_select(0, pos_d), ro, lq,
                                      uq)))
        print(f"ab cp_count_multi_packed Q={q}: bound {bound:.4f} ms, sector "
              f"floor {sector:.4f} ms; shipped through the wrapper, indexed "
              f"(host positions and ROIs staged with the flags) {wrap:.4f} "
              f"ms; gather + kernel (operands on the card) {old:.4f} ms")
        for how in ("indexed", "gathered"):
            cases[f"Q={q}, {how}"] = (want, bound, sector, fl, ro, how)
    logs: dict = {}
    libs = build("popcount", MULTI_VARIANTS, logs)
    for label, lib in libs.items():
        lib.cp_multi_packed_launch.argtypes = [P, P, L, P, P] + [I] * 4 + \
            [P, P]
        kern = "cp_multi_warp_kern" if "warp" in label else \
            "cp_multi_block_kern"
        print(f"ab cp_count_multi_packed {label}: ptxas {kern}: "
              f"{registers(logs[label], kern)}")
    for case, (want, bound, sector, fl, ro, how) in cases.items():
        src, p, m = (big, pos_d.data_ptr(), n) if how == "indexed" else \
            (gathered, None, N_RESIDENT)
        calls = {}
        for label, lib in libs.items():
            out = torch.empty_like(want)

            def run(lib=lib, out=out, fl=fl, ro=ro, src=src, p=p, m=m):
                rc = lib.cp_multi_packed_launch(
                    src.data_ptr(), p, m, fl.data_ptr(), ro.data_ptr(),
                    ro.shape[0], N_RESIDENT, h, nw, out.data_ptr(), stream)
                cuda_lib.check(rc, "cp_count_multi_packed")
            run()
            if not torch.equal(out, want):
                raise SystemExit(f"multi packed variant {label} differs")
            calls[label] = run
        for label, ms in in_turns(torch, calls).items():
            mean = sum(ms) / len(ms)
            print(f"ab cp_count_multi_packed {case}, {label}: {mean:.4f} ms "
                  f"(runs {', '.join(f'{t:.4f}' for t in ms)}), bound "
                  f"{bound:.4f} ms, {mean / bound:.2f}x, sector floor "
                  f"{mean / sector:.2f}x")


if __name__ == "__main__":
    sys.exit(main())
