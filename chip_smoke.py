#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py      # 16,384 float32 + 65,536 binary masks and
                               # 8,192 (saliency, attention) pairs, 224x224

Phases, each of which raises on failure (non-zero exit, no result line):

1. build the ten CUDA kernels from the five sources in
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together);
2. ingest 16,384 float32 saliency masks of 224x224 into a
   ``MaskStore`` on the card: ``create_memory`` on the first chunk, then
   ``append`` of the rest chunk by chunk (the CHI kernel's path), and check
   the appended CHI chunks against ``build_chi_np`` on a sample;
3. run the quickstart filter and the paper's three scenario queries on the
   device backend and on the host backend: ids, scores and the
   ``ExecStats`` counts must be identical, and ids and scores must equal
   the ``use_index=False`` naive scan;
4. check each kernel against its plain PyTorch version on the card, on the
   exact inputs of its largest main-path call and on edge cases (empty
   ROI, lv == uv, pixels on bin edges, a ragged CHI grid, binary masks,
   bf16 masks, positions that repeat or are empty, Q in every register
   bucket), with tolerance 0 (every output is an integer count), and time
   it beside the plain version and the card's bound; ``cp_count_multi``
   also as its verification step runs it (indexed reads of the resident
   array) against the gather + kernel it replaced;
5. run a 64-mask store (32 saliency/attention pairs) through the same
   queries and four pair queries on the card and on the CPU (plain kernel
   versions) and require identical answers;
6. the packed path: 65,536 binary masks (``saliency_masks > 0.5``, made
   chunk by chunk in worker processes) ingested into a packed ``MaskStore``
   on the card, the packed filter, top-k and refine queries and
   ``SCENARIO3_IOU`` on the device and host backends and as naive scans,
   and one ``fused_counts`` pass per backend; device == host == naive scan,
   ``fused_bounds_verify`` launched once per verification round, and the
   same queries on a float store of the first chunk give the packed
   store's answers;
7. the four popcount kernels against their plain versions (main-path
   inputs and edge cases, positions and misaligned planes among them;
   for ``cp_count_multi_packed`` also Q from 1 to 32, B from 1 to 4,096,
   empty and full-row ROIs, lv == uv and planes past shared memory;
   tolerance 0) and timed beside their bounds and sector floors;
   ``fused_bounds_verify`` and ``cp_count_multi_packed`` also as their
   device steps run them (one staged copy, indexed reads of the resident
   words) against the copies and gathers they replaced;
8. the pair path: 8,192 images of (model saliency, human attention) masks
   (benchmarks/bench_pair.py's recipe, made in worker processes) ingested
   as a float store and, binarised, as a packed store; on each, the
   discrepancy ranking (``SCENARIO6_DISCREPANCY``), the same on a
   grid-misaligned ROI, a ``PAIR_DIFF`` filter and scenario 6's filtered
   ranking on the device and host backends and as naive scans: device ==
   host == naive scan, the pair kernel launched once per verification round
   and naive scan, and a float store of the first binary chunk gives the
   packed store's answers;
9. the two pair kernels against their plain versions (main-path inputs and
   edge cases, tolerance 0) and timed beside their bounds and sector
   floors; ``pair_counts_packed`` also as a device round runs it (both
   roles read in place) against the two gathers it replaced.

Kernel launch counters are zeroed just before each main path (phases 2-3,
indexed queries only; phases 6 and 8, naive scans included, since they
carry ``cp_count_packed`` and the pair kernels' largest calls) and read
just after it; every kernel of that path must have been launched there.
The script prints the build, the card, the launch floor (the device time
of an empty kernel), per-query times and stats, a
``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the
repository's ``src/`` beside it; without either it exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_MASKS = 16384
N_PACKED = 65536
H = W = 224
CHUNK = 2048
PACKED_SEED = 7             # chunk c of the binary masks uses seed 7 + c
N_PAIRS = 8192              # images of the pair phase, two masks each
PAIR_JOB = 1024             # images a data worker makes per job
# PAIR_DIFF thresholds of the pair phase, tuned at 224x224 on a 2,048-image
# CPU store so that each answer is non-empty and leaves a verified residue
# on the float and the binary leg
PAIR_T_DIFF = 600
PAIR_T_RANKED = 1000
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores
# 32-bit popcounts per clock per SM, compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput)
POPC_PER_CLOCK_SM = 16

FLOAT_KERNELS = ("cp_count", "cp_count_multi", "chi_cell_hist",
                 "mask_agg_counts")
PACKED_KERNELS = ("cp_count_packed", "cp_count_multi_packed",
                  "mask_agg_counts_packed", "fused_bounds_verify")
PAIR_KERNELS = ("pair_counts", "pair_counts_packed")

FILTER_SQL = ("SELECT mask_id FROM MasksDatabaseView "
              "WHERE CP(mask, roi, (0.8, 1.0)) / AREA(roi) < 0.02;")

KERNEL_INFO = {
    "cp_count": ("src/repro_torch/kernels/csrc/cp_count.cu",
                 "src/repro/kernels/cp_count.py:47"),
    "cp_count_multi": ("src/repro_torch/kernels/csrc/cp_count.cu",
                       "src/repro/kernels/cp_count.py:89"),
    "chi_cell_hist": ("src/repro_torch/kernels/csrc/chi_build.cu",
                      "src/repro/kernels/chi_build.py:33"),
    "mask_agg_counts": ("src/repro_torch/kernels/csrc/mask_agg.cu",
                        "src/repro/kernels/mask_agg.py:25"),
    "pair_counts": ("src/repro_torch/kernels/csrc/pair_count.cu",
                    "src/repro/kernels/pair_count.py:29"),
    "cp_count_packed": ("src/repro_torch/kernels/csrc/popcount.cu",
                        "src/repro/kernels/popcount.py:108"),
    "cp_count_multi_packed": ("src/repro_torch/kernels/csrc/popcount.cu",
                              "src/repro/kernels/popcount.py:146"),
    "mask_agg_counts_packed": ("src/repro_torch/kernels/csrc/popcount.cu",
                               "src/repro/kernels/popcount.py:187"),
    "pair_counts_packed": ("src/repro_torch/kernels/csrc/popcount.cu",
                           "src/repro/kernels/popcount.py:236"),
    "fused_bounds_verify": ("src/repro_torch/kernels/csrc/popcount.cu",
                            "src/repro/kernels/popcount.py:290"),
}

STAT_FIELDS = ("n_candidates", "n_decided_by_bounds", "n_verified", "n_rounds")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sql_set(q):
    return [("quickstart_filter", FILTER_SQL),
            ("scenario1_topk", q.SCENARIO1_TOPK),
            ("scenario2_topk", q.SCENARIO2_TOPK),
            ("scenario3_iou", q.SCENARIO3_IOU)]


def make_data(n, h, w, masks_mod):
    rois = masks_mod.object_boxes(n, h, w, seed=1)
    masks, _ = masks_mod.saliency_masks(n, h, w, seed=0,
                                        attacked_fraction=0.15, boxes=rois)
    return masks, rois


def make_meta(n, dtype):
    meta = np.zeros(n, dtype)
    meta["mask_id"] = np.arange(n)
    meta["image_id"] = np.arange(n) // 2
    meta["mask_type"] = np.arange(n) % 2 + 1
    return meta


def same_answer(a, b) -> bool:
    if isinstance(a, tuple):
        return (np.array_equal(a[0], b[0]) and
                np.array_equal(np.asarray(a[1]), np.asarray(b[1])))
    return np.array_equal(a, b)


def time_ms(torch, fn, reps=20, warmup=2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.

    A device-side sleep is queued first, so the host has enqueued every
    call before the device reaches the start event: the elapsed time is
    the device's, not the Python launch overhead between short calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)          # ~0.1 s at the SM clock
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def wall_ms(torch, fn, reps=20, warmup=2) -> float:
    """Mean host wall time of ``fn`` followed by a synchronize: a step's
    time as its caller waits for it, host work and blocking copies
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def sector_bytes(torch, needed, per_sector: int) -> int:
    """Bytes of the 32-byte sectors that the True entries of a contiguous
    element map lie in (``per_sector`` elements a sector, the array on a
    sector boundary): what the memory system moves for those elements."""
    flat = needed.reshape(-1)
    pad = (-flat.numel()) % per_sector
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return int(flat.view(-1, per_sector).any(1).sum()) * 32


def roi_pixels(torch, rois, h, w):
    r = rois.to(torch.int64)
    hh = (r[..., 2].clamp(max=h) - r[..., 0].clamp(min=0)).clamp(min=0)
    ww = (r[..., 3].clamp(max=w) - r[..., 1].clamp(min=0)).clamp(min=0)
    return hh * ww


def bound_of(torch, ref, name, args):
    """(bound_ms, bound_by): each input byte the function needs read once,
    each output byte written once, over the HBM rate, against its compare
    and add operations over the f32 rate — whichever is larger."""
    x = args[0]
    isz = x.element_size()
    if name == "cp_count":
        b, h, w = x.shape
        px = int(roi_pixels(torch, torch.as_tensor(args[1]).to(x.device),
                            h, w).sum())
        nbytes = px * isz + b * 16 + b * 4
        ops = px * 4
    elif name == "cp_count_multi":
        pos_bytes = 8 * len(args[4]) if len(args) > 4 and args[4] is not None \
            else 0
        x = gathered(name, args)[0]
        b, h, w = x.shape
        rois = torch.as_tensor(args[1]).to(x.device, torch.int32)
        union = torch.zeros((b, h, w), dtype=torch.bool, device=x.device)
        for q in range(rois.shape[0]):
            union |= ref._roi_mask(rois[q], h, w)
        px = int(union.sum())
        q = rois.shape[0]
        nbytes = px * isz + q * b * 16 + q * 8 + q * b * 4 + pos_bytes
        ops = int(roi_pixels(torch, rois, h, w).sum()) * 4
    elif name == "chi_cell_hist":
        b, h, w = x.shape
        nb = torch.as_tensor(args[1]).numel() + 1
        g = int(args[2])
        nbytes = b * h * w * isz + (nb - 1) * 4 + b * g * g * nb * 4
        ops = b * h * w * nb
    else:  # mask_agg_counts
        n, s, h, w = x.shape
        px = int(roi_pixels(torch, torch.as_tensor(args[1]).to(x.device),
                            h, w).sum())
        nbytes = px * s * isz + n * 16 + n * 8
        ops = px * s * 3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    if isinstance(got, tuple):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0.0


def edge_cases(torch, ops, ref):
    """Small inputs on the card held to exact equality with the plain
    versions: the kernel tests' shapes in f32 and bf16, empty ROIs,
    lv == uv, pixels exactly on CHI bin edges, ragged CHI grids."""
    dev = torch.device("cuda")
    shapes = [(3, 64, 64), (2, 128, 256), (5, 96, 160), (1, 256, 256),
              (4, 32, 512), (3, 50, 70), (2, 224, 224)]
    n_cases = {k.name: 0 for k in ops.KERNELS}

    def check(name, got, want):
        n_cases[name.split()[0]] += 1
        if max_abs_err(torch, got, want) != 0:
            fail(f"{name} differs from its plain version")

    for si, (b, h, w) in enumerate(shapes):
        rng = np.random.default_rng(100 + si)
        base = rng.random((b, h, w), dtype=np.float32)
        r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
        c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
        rois = torch.as_tensor(np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]],
                                        1).astype(np.int32), device=dev)
        empty = rois.clone()
        empty[:, 2] = empty[:, 0]
        for dt in (torch.float32, torch.bfloat16):
            m = torch.as_tensor(base, device=dev).to(dt)
            for lv, uv in ((0.25, 0.8), (0.5, 0.5), (0.0, 1.0), (0.7, 0.802)):
                check("cp_count", ops.cp_count(m, rois, lv, uv),
                      ref.cp_count_ref(m, rois, lv, uv))
            check("cp_count empty roi", ops.cp_count(m, empty, 0.0, 1.0),
                  ref.cp_count_ref(m, empty, 0.0, 1.0))
            rois_q = torch.stack([rois, empty, rois.flip(0)])
            lvs = torch.tensor([0.25, 0.5, 0.1])
            uvs = torch.tensor([0.8, 0.5, 3.4e38])
            check("cp_count_multi", ops.cp_count_multi(m, rois_q, lvs, uvs),
                  ref.cp_count_multi_ref(m, rois_q, lvs, uvs))
            # positions over the leading axis (repeated, unsorted, none),
            # Q in every register bucket of the kernel and above the largest
            for pos in ([b - 1, 0, b - 1, 0], list(range(b))[::-1], []):
                p = torch.tensor(pos, dtype=torch.int64, device=dev)
                for q in (1, 2, 5, 9):
                    rq = torch.stack([rois, empty, rois.flip(0)] * 3)[:q][:, p]
                    lq = torch.linspace(0.05, 0.6, q)
                    uq = lq + 0.35
                    check("cp_count_multi positions",
                          ops.cp_count_multi(m, rq, lq, uq, p),
                          ref.cp_count_multi_ref(m, rq, lq, uq, p))
            if b >= 2:
                gm = m[: (b // 2) * 2].reshape(b // 2, 2, h, w).contiguous()
                gr = rois[: b // 2]
                for t in (0.5, 0.8):
                    check("mask_agg_counts", ops.mask_agg_counts(gm, gr, t),
                          ref.mask_agg_counts_ref(gm, gr, t))
        # CHI: values exactly on the uniform bin edges k/16 mixed in
        edges = torch.arange(1, 16, dtype=torch.float32) / 16
        onedge = base.copy()
        pick = rng.random(base.shape) < 0.3
        onedge[pick] = (rng.integers(0, 17, pick.sum()) / 16).astype(
            np.float32)
        m = torch.as_tensor(onedge, device=dev)
        for g in (4, 8, 16, 7):   # 7 and 16 are ragged for some shapes
            check("chi_cell_hist", ops.chi_cell_hist(m, edges, g),
                  ref.chi_cell_hist_ref(m, edges, g))
        # other bin counts (the search pads 4 and 16 edges with +inf), and
        # binary masks (every pixel in the first or the last bin)
        for nb in (5, 17):
            e2 = torch.arange(1, nb, dtype=torch.float32) / nb
            check("chi_cell_hist nb", ops.chi_cell_hist(m, e2, 16),
                  ref.chi_cell_hist_ref(m, e2, 16))
        binary = (m > 0.5).float()
        for g in (16, 7):
            check("chi_cell_hist binary", ops.chi_cell_hist(binary, edges, g),
                  ref.chi_cell_hist_ref(binary, edges, g))
    torch.cuda.synchronize()
    return n_cases


def packed_sql(q):
    roi_cp = "CP(mask, roi, (0.5, 1.5))"
    offgrid = "CP(mask, (3, 5, 221, 223), (0.5, 1.5))"  # grid-misaligned
    return [("packed_filter", "SELECT mask_id FROM MasksDatabaseView WHERE "
             f"{roi_cp} / AREA(roi) < 0.5;"),
            ("packed_topk", "SELECT mask_id FROM MasksDatabaseView "
             f"ORDER BY {offgrid} DESC LIMIT 25;"),
            ("packed_refine", "SELECT mask_id FROM MasksDatabaseView WHERE "
             f"{roi_cp} > 500 AND NOT CP(mask, full_img, (0.5, 1.5)) < 2000 "
             f"ORDER BY {offgrid} DESC LIMIT 25;"),
            ("scenario3_iou", q.SCENARIO3_IOU)]


def binary_chunk(job):
    """Chunk ``c`` of the binary masks: ``saliency_masks > 0.5`` (the
    binarisation of benchmarks/bench_backend.py) from seed 7 + c, as bool.
    Runs in a worker process, so the host never holds the float masks of
    more than a few chunks."""
    c, boxes = job
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.data import masks as masks_mod
    m, _ = masks_mod.saliency_masks(len(boxes), H, W, seed=PACKED_SEED + c,
                                    attacked_fraction=0.2, boxes=boxes,
                                    in_box_fraction=0.9)
    return m > 0.5


# The kernels that read a resident array in place: argument index of each
# position list -> index of the mask operand it indexes.
POSITION_ARGS = {"cp_count_multi": {4: 0},
                 "cp_count_multi_packed": {4: 0},
                 "fused_bounds_verify": {6: 0},
                 "pair_counts_packed": {5: 0, 6: 1}}


def positions_of(name, a) -> list:
    """The position lists a kernel call carried (none: the batch as
    given)."""
    return [a[i] for i in POSITION_ARGS.get(name, ())
            if len(a) > i and a[i] is not None]


def call_size(name, a):
    """Elements a kernel call reads from: the batch, or for a call with
    positions (on the resident array) len(positions) masks of it."""
    pos = positions_of(name, a)
    if pos:
        return len(pos[0]) * a[0].shape[1] * a[0].shape[2]
    return a[0].numel()


def gathered(name, a):
    """A kernel call's arguments with its positions resolved: the gathered
    batches ``masks[positions]`` (what the plain version, the bound and
    the kernel alone are measured on)."""
    import torch
    idx = POSITION_ARGS.get(name)
    if not idx:
        return a
    out = list(a[:min(idx)])
    for i, t in idx.items():
        if len(a) > i and a[i] is not None:
            out[t] = a[t][torch.as_tensor(a[i], device=a[t].device)]
    return tuple(out)


def record_largest(ops, names, largest):
    """Wrap the CUDA launchers of kernels ``names`` so that each keeps the
    arguments of its largest call in ``largest[name]`` (and of its largest
    call with positions in ``largest[(name, "indexed")]``); returns the
    undo."""
    saved = {k.name: k.cuda for k in ops.KERNELS if k.name in names}
    for k in ops.KERNELS:
        if k.name not in saved:
            continue

        def rec(*a, name=k.name, launch=k.cuda):
            size = call_size(name, a)
            keys = [name] + ([(name, "indexed")] if positions_of(name, a)
                             else [])
            for key in keys:
                if size >= largest.get(key, (-1, None))[0]:
                    largest[key] = (size, a)
            return launch(*a)
        k.cuda = rec

    def undo():
        for k in ops.KERNELS:
            if k.name in saved:
                k.cuda = saved[k.name]
    return undo


def touched_words(torch, rois, h, nw):
    """(..., 4) ROIs → (..., H, nw) bool: the words of each ROI's rows that
    its columns touch (rows clipped to [0, H), columns to [0, 32 nw))."""
    r = rois.to(torch.int64)
    w32 = 32 * nw
    r0, r1 = r[..., 0].clamp(0, h), r[..., 2].clamp(0, h)
    c0, c1 = r[..., 1].clamp(0, w32), r[..., 3].clamp(0, w32)
    rr = torch.arange(h, device=r.device)
    kk = torch.arange(nw, device=r.device) * 32
    rows = (rr >= r0[..., None]) & (rr < r1[..., None])
    cols = ((kk < c1[..., None]) & (kk + 32 > c0[..., None]) &
            (c1 > c0)[..., None])
    return rows[..., :, None] & cols[..., None, :]


def packed_bound_of(torch, ref, name, args, popc_per_s):
    """(bound_ms, bound_by, sector_ms) of a popcount kernel call: the words
    of ROI rows that the ROI touches, read once (4 B each, plus 16 B per
    counted ROI, 12 B per (q, b) of decided / lb / output for the
    megakernel, 4 B per other output), over the HBM rate, against one
    popcount per touched word and counted descriptor (two for MASK_AGG: AND
    and OR) over the card's popcount rate — whichever is larger.  The
    sector floor moves the 32-byte sectors those words lie in instead of
    the words, the same other bytes, over the HBM rate."""
    x = args[0]
    dev = x.device
    if name == "mask_agg_counts_packed":
        n, s, h, nw = x.shape
        rois = torch.as_tensor(args[1]).to(dev)
        touched = touched_words(torch, rois, h, nw)
        words = int(touched.sum())
        other = n * 16 + n * 8
        nbytes = words * s * 4 + other
        sectors = sector_bytes(torch, touched[:, None].expand(n, s, h, nw),
                               8)
        popc = 2 * words
    else:
        b, h, nw = x.shape
        rois = torch.as_tensor(args[1]).to(dev).reshape(-1, b, 4)
        flags = torch.as_tensor(ref._range_flags(args[2], args[3]).reshape(
            -1, 2)).to(dev)
        q = rois.shape[0]
        counted = flags.any(1)[:, None].expand(q, b)
        out_b = 4
        if name == "fused_bounds_verify":
            counted = counted & (torch.as_tensor(args[4]).to(dev) == 0)
            out_b = 12
        words = touched_words(torch, rois, h, nw) & counted[..., None, None]
        popc = int(words.sum())
        needed = words.any(0)
        other = int(counted.sum()) * 16 + q * b * out_b
        nbytes = int(needed.sum()) * 4 + other
        sectors = sector_bytes(torch, needed, 8)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = popc / popc_per_s * 1e3
    sector_ms = (sectors + other) / PEAK_BYTES_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", sector_ms
    return t_ops, "operations", sector_ms


def packed_edge_cases(torch, ops, ref, pack_masks, dev):
    """The popcount kernels on the card against their plain versions, with
    tolerance 0: tail bits (W = 33, 40), empty and unclipped ROIs, columns
    on word edges, every flag pair from lv/uv/t in {-0.5, 0, 0.5, 1, 1.5},
    all-decided and none-decided megakernel batches, rows of more than 32
    words."""
    vals = (-0.5, 0.0, 0.5, 1.0, 1.5)
    n_cases = dict.fromkeys(PACKED_KERNELS, 0)

    def check(name, got, want):
        n_cases[name] += 1
        if max_abs_err(torch, got, want) != 0:
            fail(f"{name} differs from its plain version on an edge case")

    for si, (b, h, w) in enumerate([(6, 16, 33), (6, 16, 40), (4, 224, 224),
                                    (5, 9, 64), (2, 5, 1100)]):
        rng = np.random.default_rng(300 + si)
        m = torch.as_tensor(pack_masks(rng.random((b, h, w)) < 0.4).view(
            np.int32), device=dev)
        nw = m.shape[2]
        r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
        c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
        rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
        edges = [(0, 0, h, 64), (-3, -5, h + 2, 32 * nw + 9), (2, 3, 2, 20),
                 (1, 32, h, 64), (0, 31, h, 33), (1, 0, h - 1, 32)]
        rois[:min(b, len(edges))] = edges[:b]
        rois = torch.as_tensor(rois.astype(np.int32), device=dev)
        for lv in vals:
            for uv in vals:
                check("cp_count_packed", ops.cp_count_packed(m, rois, lv, uv),
                      ref.cp_count_packed_ref(m, rois, lv, uv))
        rois_q = torch.stack([rois, rois.flip(0), rois])
        lvs, uvs = np.float32([0.5, -0.5, 0.0]), np.float32([1.5, 0.5, 1.0])
        check("cp_count_multi_packed",
              ops.cp_count_multi_packed(m, rois_q, lvs, uvs),
              ref.cp_count_multi_packed_ref(m, rois_q, lvs, uvs))
        n_cases["cp_count_multi_packed"] += multi_packed_edge_cases(
            torch, ops, ref, m, rois)
        lb = rng.integers(0, 1000, (3, b)).astype(np.int32)
        mixed = rng.random((3, b)) < 0.5
        mixed[:, 0] = True          # a mask whose entries are all decided
        for dec in (mixed, np.ones((3, b), bool), np.zeros((3, b), bool)):
            dec = dec.astype(np.int32)
            for words in (m, misaligned(torch, m)):
                check("fused_bounds_verify",
                      ops.fused_bounds_verify(words, rois_q, lvs, uvs, dec,
                                              lb),
                      ref.fused_bounds_verify_ref(words, rois_q, lvs, uvs,
                                                  dec, lb))
                # positions that repeat, run backwards, or are empty
                for pos in ([b - 1, 0, b - 1, 0], list(range(b))[::-1], []):
                    pn = np.asarray(pos, np.int64)
                    args = (words, rois_q[:, torch.as_tensor(pn)], lvs, uvs,
                            dec[:, pn], lb[:, pn], pn)
                    check("fused_bounds_verify",
                          ops.fused_bounds_verify(*args),
                          ref.fused_bounds_verify_ref(*args))
        grp = m[: (b // 2) * 2].reshape(b // 2, 2, h, nw).contiguous()
        for t in vals:
            check("mask_agg_counts_packed",
                  ops.mask_agg_counts_packed(grp, rois[: b // 2], t),
                  ref.mask_agg_counts_packed_ref(grp, rois[: b // 2], t))
    # cp_count_multi_packed on planes past shared memory (400 rows of 35
    # words, counted from device memory), and from 1 to 4,096 masks
    rng = np.random.default_rng(320)
    m = torch.as_tensor(pack_masks(rng.random((3, 400, 1100)) < 0.4).view(
        np.int32), device=dev)
    rois = torch.as_tensor(np.int32([[0, 0, 400, 1120], [5, 31, 399, 700],
                                     [-2, 3, 7, 1200]]), device=dev)
    n_cases["cp_count_multi_packed"] += multi_packed_edge_cases(
        torch, ops, ref, m, rois)
    n_cases["cp_count_multi_packed"] += multi_packed_batch_cases(
        torch, ops, ref, pack_masks, dev)
    torch.cuda.synchronize()
    return n_cases


# Q of the multi-descriptor edge cases, and range flag pairs in turn
# (lv == uv, which counts nothing, among them)
MULTI_QS = (1, 2, 3, 5, 8, 9, 17, 32)
MULTI_RANGES = ((0.5, 1.5), (-0.5, 0.5), (0.0, 1.0), (0.5, 0.5),
                (1.0, 1.5), (-0.5, 1.5))


def multi_packed_edge_cases(torch, ops, ref, m, rois) -> int:
    """``cp_count_multi_packed`` against its plain version (tolerance 0) on
    words ``m`` (b, h, nw) with ROIs ``rois`` (b, 4): Q from 1 to 32 over
    the ROIs, empty ROIs, full rows and the ROIs reversed in turn, with the
    flag pairs of MULTI_RANGES; without positions and with positions that
    repeat, run backwards or are empty; on the planes as given and on a
    misaligned copy.  Returns the number of cases."""
    b, h, nw = m.shape
    empty = rois.clone()
    empty[:, 2] = empty[:, 0]
    full = torch.tensor([0, 0, h, 32 * nw], dtype=torch.int32,
                        device=m.device).expand_as(rois)
    pool = (rois, empty, full, rois.flip(0))
    n = 0
    for words in (m, misaligned(torch, m)):
        for pos in (None, [b - 1, 0, b - 1, 0], list(range(b))[::-1], []):
            pn = None if pos is None else np.asarray(pos, np.int64)
            for q in MULTI_QS:
                rq = torch.stack([pool[i % 4] for i in range(q)])
                if pn is not None:
                    rq = rq[:, torch.as_tensor(pn, device=m.device)]
                lq = np.float32([MULTI_RANGES[i % 6][0] for i in range(q)])
                uq = np.float32([MULTI_RANGES[i % 6][1] for i in range(q)])
                err = max_abs_err(torch, ops.cp_count_multi_packed(
                    words, rq, lq, uq, pn), ref.cp_count_multi_packed_ref(
                    words, rq, lq, uq, pn))
                if err != 0:
                    fail(f"cp_count_multi_packed differs from its plain "
                         f"version on {tuple(m.shape)} words, Q={q}, "
                         f"positions {pos}")
                n += 1
    return n


def multi_packed_batch_cases(torch, ops, ref, pack_masks, dev) -> int:
    """``cp_count_multi_packed`` over 1 to 4,096 positions (drawn with
    repeats) into 512 resident 224x224 masks, with the scheduler pass's 8
    descriptors: indexed with host positions and with positions on the
    card, and gathered; tolerance 0.  Returns the number of cases."""
    from repro_torch.core.backend import spec_arrays
    from repro_torch.data.masks import object_boxes
    rng = np.random.default_rng(330)
    words = torch.as_tensor(pack_masks(rng.random((512, H, W)) < 0.4).view(
        np.int32), device=dev)
    n = 0
    for b in (1, 7, 708, 4096):
        pos = rng.integers(0, 512, b)
        rois_q, lvs, uvs = spec_arrays(fused_specs(object_boxes(b, H, W,
                                                                seed=b)))
        want = ref.cp_count_multi_packed_ref(words, rois_q, lvs, uvs, pos)
        pos_d = torch.as_tensor(pos, device=dev)
        for got in (ops.cp_count_multi_packed(words, rois_q, lvs, uvs, pos),
                    ops.cp_count_multi_packed(words, torch.as_tensor(
                        rois_q, device=dev), lvs, uvs, pos_d),
                    ops.cp_count_multi_packed(words[pos_d], rois_q, lvs,
                                              uvs)):
            if max_abs_err(torch, got, want) != 0:
                fail(f"cp_count_multi_packed differs from its plain version "
                     f"on {b} of 512 resident masks")
            n += 1
    return n


def pair_sql(q, t_diff, t_ranked):
    """The pair phase's four queries: the paper's discrepancy ranking, the
    same on a grid-misaligned ROI (so the CHI leaves a residue), a
    saliency-minus-attention filter over the object boxes and scenario 6's
    filtered ranking."""
    diff = "PAIR_DIFF(saliency, attention, 0.6, 0.6, roi)"
    return [("pair_iou_topk", q.SCENARIO6_DISCREPANCY),
            ("pair_iou_roi", "SELECT image_id FROM MasksDatabaseView ORDER BY "
             "IOU(saliency, attention, 0.6, 0.6, (3, 5, 221, 223)) ASC "
             "LIMIT 25;"),
            ("pair_diff_filter", "SELECT image_id FROM MasksDatabaseView "
             f"WHERE {diff} > {t_diff};"),
            ("pair_filtered_topk", "SELECT image_id FROM MasksDatabaseView "
             f"WHERE {diff} > {t_ranked} ORDER BY {diff} DESC LIMIT 25;")]


def pair_job(job):
    """Images ``[s, s + n)`` of the pair data, the recipe of
    benchmarks/bench_pair.py ``_setup``: model saliency centred in the
    object box, human attention ``0.9 model + 0.25 jitter`` where aligned
    and an off-object gaze where misaligned.  Job ``j`` draws the model,
    jitter and gaze from seeds 5, 6 and 7 + 1000 j.  Returns the float32
    masks (2n, H, W), (saliency, attention) per image, and the binary leg of
    ``_setup_binary`` (attention = the model where aligned; ``> 0.5``) as
    bool.  Runs in a worker process."""
    j, boxes, misaligned = job
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.data.masks import saliency_masks
    n = len(boxes)
    model, _ = saliency_masks(n, H, W, seed=5 + 1000 * j, boxes=boxes,
                              in_box_fraction=1.0)
    jitter, _ = saliency_masks(n, H, W, seed=6 + 1000 * j, boxes=boxes,
                               in_box_fraction=1.0)
    off, _ = saliency_masks(n, H, W, seed=7 + 1000 * j, boxes=None)
    mis = misaligned[:, None, None]
    human = np.where(mis, off, np.clip(0.9 * model + 0.25 * jitter, 0.0,
                                       1.0 - 1e-6))
    masks = np.stack([model, human], axis=1).reshape(-1, H, W)
    binary = np.stack([model > 0.5, np.where(mis, off, model) > 0.5],
                      axis=1).reshape(-1, H, W)
    return masks, binary


def pair_data(n_images):
    """Object boxes (seed 4), the 8% misaligned images
    (``default_rng(3)``) and the data jobs of ``PAIR_JOB`` images each."""
    from repro_torch.data.masks import object_boxes
    boxes = object_boxes(n_images, H, W, seed=4)
    misaligned = np.random.default_rng(3).random(n_images) < 0.08
    jobs = [(j, boxes[s:s + PAIR_JOB], misaligned[s:s + PAIR_JOB])
            for j, s in enumerate(range(0, n_images, PAIR_JOB))]
    return boxes, misaligned, jobs


def ingest(torch, MaskStore, cfg, dev, meta, chunks, ops, packed):
    """``create_memory`` on the first chunk, then ``append`` of the rest,
    each call timed to its end on the card.  Returns the store, the first
    chunk and the last."""
    label = "packed ingest" if packed else "ingest"
    chunks = iter(chunks)
    first = next(chunks)
    t1 = time.perf_counter()
    store = MaskStore.create_memory(first, meta[:len(first)], cfg,
                                    packed=packed, device=dev)
    torch.cuda.synchronize()
    t_create = time.perf_counter() - t1
    t_app, last, at = [], first, len(first)
    for chunk in chunks:
        t1 = time.perf_counter()
        store.append(chunk, meta[at:at + len(chunk)])
        torch.cuda.synchronize()
        t_app.append(time.perf_counter() - t1)
        at += len(chunk)
        last = chunk
    print(f"{label}: create_memory({len(first)}) {t_create:.3f} s, "
          f"{len(t_app)} x append({len(last)}) {sum(t_app):.3f} s "
          f"(each {', '.join(f'{t:.3f}' for t in t_app)}), "
          f"total {t_create + sum(t_app):.3f} s; chi_cell_hist launches "
          f"{ops.launch_counts()['chi_cell_hist']}")
    return store, first, last


def run_queries(torch, tq, ops, store, sqls, provided, prefix):
    """Each query on the device backend, then the host backend; prints the
    wall time, ``ExecStats`` and kernel launches of each run."""
    results: dict = {}
    for qname, sql in sqls:
        for be in ("device", "host"):
            before = ops.launch_counts()
            t1 = time.perf_counter()
            res, stats = tq.run(sql, store, provided_rois=provided,
                                backend=be)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            after = ops.launch_counts()
            launches = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            results[(qname, be)] = (res, stats, launches)
            n_out = len(res[0]) if isinstance(res, tuple) else len(res)
            print(f"{prefix}query {qname} backend={be}: {wall:.3f} s, "
                  f"{n_out} ids, "
                  + json.dumps({f: getattr(stats, f) for f in STAT_FIELDS
                                + ("bytes_loaded", "chi_bytes")})
                  + f", launches {json.dumps(launches)}")
    return results


def naive_scans(torch, tq, ops, store, sqls, provided):
    """Each query as a ``use_index=False`` scan: (answer, stats, seconds,
    kernel launches) per query."""
    out = {}
    for qname, sql in sqls:
        before = ops.launch_counts()
        t1 = time.perf_counter()
        res, stats = tq.run(sql, store, provided_rois=provided,
                            use_index=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        after = ops.launch_counts()
        out[qname] = (res, stats, secs, {k: after[k] - before[k]
                                         for k in after})
    return out


def check_answers(results, naive, sqls, prefix):
    """Device == host (answers and ``ExecStats`` counts) == naive scan."""
    for qname, _ in sqls:
        rd, sd, _ = results[(qname, "device")]
        rh, sh, _ = results[(qname, "host")]
        if not same_answer(rd, rh):
            fail(f"{prefix}{qname}: device and host answers differ")
        for f in STAT_FIELDS:
            if getattr(sd, f) != getattr(sh, f):
                fail(f"{prefix}{qname}: {f} differs (device "
                     f"{getattr(sd, f)}, host {getattr(sh, f)})")
        if isinstance(rd, tuple) and not np.all(np.isfinite(rd[1])):
            fail(f"{prefix}{qname}: non-finite scores")
        rn, sn, secs, _ = naive[qname]
        if not same_answer(rd, rn):
            fail(f"{prefix}{qname}: indexed answer differs from the naive "
                 f"scan")
        print(f"{prefix}check {qname}: device == host == naive scan "
              f"({sn.n_verified} candidates scanned in {secs:.3f} s)")


def step_times(torch, routes) -> dict:
    """Each route of a step timed on the device timeline (``time_ms``) and
    on the host clock with a synchronize after each call (``wall_ms``),
    old and new in turns: old, new, new, old."""
    order = list(routes) + list(routes)[::-1]
    runs = {r: [] for r in routes}
    for r in order:
        runs[r].append((time_ms(torch, routes[r]), wall_ms(torch, routes[r])))
    return {r: tuple(sum(v) / len(v) for v in zip(*t))
            for r, t in runs.items()}


def print_step(name, what, t):
    (old_label, (old_dev, old_wall)), (new_label, (new_dev, new_wall)) = \
        t.items()
    print(f"main-path step {name}: {what}; device time {old_label} "
          f"{old_dev:.4f} ms, {new_label} {new_dev:.4f} ms "
          f"({old_dev / new_dev:.2f}x); host wall with a synchronize "
          f"{old_wall:.4f} ms, {new_wall:.4f} ms "
          f"({old_wall / new_wall:.2f}x)")


def multi_main_path_step(torch, ops, ref, a):
    """``cp_count_multi``'s largest main-path call as the step runs it: the
    indexed kernel on the resident array, held against its plain version
    (tolerance 0) and timed against the gather + kernel on the gathered
    batch, the step's route before positions.  Returns the gathered
    call's arguments, on which the kernel alone is measured."""
    if len(a) <= 4 or a[4] is None:
        fail("the largest cp_count_multi call carried no positions")
    err = max_abs_err(torch, ops.cp_count_multi(*a),
                      ref.cp_count_multi_ref(*a))
    if err != 0:
        fail(f"indexed cp_count_multi differs from its plain version "
             f"(max abs err {err})")
    pos = a[4]
    t = step_times(torch, {
        "gather + kernel": lambda: ops.cp_count_multi(a[0][pos], *a[1:4]),
        "indexed kernel": lambda: ops.cp_count_multi(*a)})
    print_step("cp_count_multi", f"{len(pos)} of {a[0].shape[0]} resident "
               f"masks, Q={a[1].shape[0]}, indexed equal", t)
    return gathered("cp_count_multi", a)


def fused_main_path_step(torch, ops, ref, a):
    """``fused_bounds_verify``'s largest indexed main-path call as the
    device step runs it: one staged copy of its host operands and the
    indexed kernel on the resident words, held against its plain version
    (tolerance 0) and timed against the gathering route: four pageable
    copies (positions, ROIs, verdicts, bounds), a pinned copy of the
    flags, a gather and the kernel on the gathered batch.  The old route's
    pageable copies each block the host until the card drains, so its span
    on the device timeline counts host stalls that the new route, queued
    whole behind the sleep, does not show: the host clock compares what a
    caller waits for.  Returns the gathered call's arguments, on which the
    kernel alone is measured."""
    from repro_torch.kernels import cuda_lib, popcount
    if len(a) <= 6 or a[6] is None:
        fail("the largest indexed fused_bounds_verify call carried no "
             "positions")
    packed, rois, lvs, uvs, dec, lb, pos = a
    dev = packed.device
    flags = ref._range_flags(lvs, uvs).reshape(-1, 2)

    def old():
        pos_d = torch.from_numpy(pos).to(dev)
        rois_d = torch.from_numpy(rois).to(dev)
        dec_d = torch.from_numpy(dec).to(dev)
        lb_d = torch.from_numpy(lb).to(dev)
        flags_d = cuda_lib.to_card(flags, dev)
        return popcount.fused_verify_launch(packed.index_select(0, pos_d),
                                            flags_d, rois_d, dec_d, lb_d)

    def new():
        return ops.fused_bounds_verify(*a)
    want = ref.fused_bounds_verify_ref(*a)
    for route in (old, new):
        err = max_abs_err(torch, route(), want)
        if err != 0:
            fail(f"fused_bounds_verify step ({route.__name__} route) differs "
                 f"from its plain version (max abs err {err})")
    t = step_times(torch, {"4 copies + gather + kernel": old,
                           "1 staged copy + indexed kernel": new})
    print_step("fused_bounds_verify",
               f"{len(pos)} of {packed.shape[0]} resident masks, "
               f"Q={rois.shape[0]}, {int(dec.sum())} entries decided, both "
               f"routes equal, the old route's span with its host stalls",
               t)
    return gathered("fused_bounds_verify", a)


def multi_packed_main_path_step(torch, ops, ref, a):
    """``cp_count_multi_packed``'s largest indexed main-path call (the
    device backend's fused pass): the indexed kernel on the resident words,
    held against its plain version (tolerance 0), and timed against the
    gathering route twice.  First with every operand on the card: a gather
    and the kernel on the gathered batch against the kernel reading in
    place.  Then as the device step ran before and runs now: pageable
    copies of positions and ROIs, a gather and the kernel, against one
    staged copy and the indexed kernel; the old route's pageable copies
    block the host inside its device-timeline span, so the host clock
    compares what a caller waits for.  Returns the gathered call's
    arguments with the ROIs on the card, on which the kernel alone is
    measured."""
    if len(a) <= 4 or a[4] is None:
        fail("the largest indexed cp_count_multi_packed call carried no "
             "positions")
    packed, rois, lvs, uvs, pos = a
    dev = packed.device
    pos_d = torch.as_tensor(pos).to(dev)
    rois_d = torch.as_tensor(rois).to(dev)

    def old():
        return ops.cp_count_multi_packed(
            packed.index_select(0, torch.from_numpy(pos).to(dev)),
            torch.from_numpy(rois).to(dev), lvs, uvs)

    def new():
        return ops.cp_count_multi_packed(*a)
    routes = {
        "gather + kernel": lambda: ops.cp_count_multi_packed(
            packed.index_select(0, pos_d), rois_d, lvs, uvs),
        "indexed kernel": lambda: ops.cp_count_multi_packed(
            packed, rois_d, lvs, uvs, pos_d)}
    step = {"2 pageable copies + gather + kernel": old,
            "1 staged copy + indexed kernel": new}
    want = ref.cp_count_multi_packed_ref(*a)
    for label, route in {**routes, **step}.items():
        err = max_abs_err(torch, route(), want)
        if err != 0:
            fail(f"cp_count_multi_packed step ({label}) differs from its "
                 f"plain version (max abs err {err})")
    what = (f"{len(pos)} of {packed.shape[0]} resident masks, "
            f"Q={rois.shape[0]}")
    print_step("cp_count_multi_packed", f"{what}, operands on the card, "
               f"both routes equal", step_times(torch, routes))
    print_step("cp_count_multi_packed", f"{what}, host positions and ROIs "
               f"as the device step passes them, both routes equal, the old "
               f"route's span with its host stalls", step_times(torch, step))
    # the kernel alone, its ROIs on the card as the host backend passes
    # them: only the flags are staged
    return (gathered("cp_count_multi_packed", a)[0], rois_d, lvs, uvs)


def pair_main_path_step(torch, ops, ref, a):
    """``pair_counts_packed``'s largest indexed main-path call (a device
    verification round): the kernel reading both roles in place, held
    against its plain version (tolerance 0) and timed against the
    gathering route, a gather of each role and the kernel on the gathered
    batches."""
    if len(a) <= 6 or a[5] is None or a[6] is None:
        fail("the largest indexed pair_counts_packed call carried no "
             "positions")
    pa, pb, rois, ta, tb, pos_a, pos_b = a

    def old():
        return ops.pair_counts_packed(pa.index_select(0, pos_a),
                                      pb.index_select(0, pos_b), rois, ta, tb)

    def new():
        return ops.pair_counts_packed(*a)
    want = ref.pair_counts_packed_ref(*a)
    for route in (old, new):
        err = max_abs_err(torch, route(), want)
        if err != 0:
            fail(f"pair_counts_packed step ({route.__name__} route) differs "
                 f"from its plain version (max abs err {err})")
    t = step_times(torch, {"2 gathers + kernel": old,
                           "indexed kernel": new})
    print_step("pair_counts_packed",
               f"{len(pos_a)} pairs of {pa.shape[0]} resident masks, both "
               f"routes equal", t)


def misaligned(torch, words):
    """The same words in a copy whose base is one word past a 16-byte
    boundary: the megakernel stages such planes word by word."""
    buf = torch.empty(words.numel() + 1, dtype=words.dtype,
                      device=words.device)
    out = buf[1:].view(words.shape)
    out.copy_(words)
    return out


def kernel_entry(torch, ops, name, a, plain, launches, n_edge, bound,
                 floor_ms=None):
    """Hold a kernel against its plain version on its largest main-path
    call (tolerance 0), time both, and return its ``kernels`` entry.  The
    parity line adds the sector floor where ``bound`` gives one, and the
    launch floor ``floor_ms`` where given."""
    k = getattr(ops, name)
    got = k(*a)
    want = plain(*a)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if err != 0:
        fail(f"{name} differs from its plain version at main-path shape "
             f"{tuple(a[0].shape)} (max abs err {err})")
    ms = time_ms(torch, lambda: k(*a))
    plain_ms = time_ms(torch, lambda: plain(*a), reps=3, warmup=1)
    bound_ms, bound_by, *sector = bound(name, a)
    floors = "".join([f", sector floor {sector[0]:.4f} ms" if sector else "",
                      f", launch floor {floor_ms:.4f} ms"
                      if floor_ms is not None else ""])
    src, replaces = KERNEL_INFO[name]
    print(f"parity {name}: main-path shape {tuple(a[0].shape)} "
          f"{str(a[0].dtype).replace('torch.', '')} equal, "
          f"{n_edge} edge cases equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}){floors}, library none")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def fused_specs(provided):
    """The scheduler pass's 8 descriptors over masks whose ROIs are
    ``provided``: per-mask boxes, full image, the grid-misaligned ROI, word
    edges, an empty ROI, and every CP flag pair."""
    n = len(provided)

    def const(r):
        return np.tile(np.asarray(r, np.int32), (n, 1))

    full = const([0, 0, H, W])
    return [(provided, 0.5, 1.5), (full, 0.5, 1.5), (full, -0.5, 0.5),
            (const([3, 5, 221, 223]), 0.5, 1.5), (provided, 0.0, 1.0),
            (const([0, 32, 224, 64]), 0.5, float("inf")),
            (const([100, 0, 150, 224]), 1.0, 1.5),
            (const([10, 10, 10, 100]), 0.5, 1.5)]


def card_popcount_rate(torch) -> float:
    """32-bit popcounts per second at the card's maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = POPC_PER_CLOCK_SM * sms * mhz * 1e6
    print(f"popcount rate: {POPC_PER_CLOCK_SM} x {sms} SMs x {mhz:.0f} MHz "
          f"= {rate:.4g}/s")
    return rate


def packed_phase(torch, dev, n, floor_ms):
    """Phases 6-7: the packed path on ``n`` binary masks; returns the four
    popcount kernels' ``kernels`` entries.  ``floor_ms`` is the launch
    floor, printed beside the megakernel."""
    from repro_torch.core import CHIConfig, MaskStore, build_chi_np
    from repro_torch.core import get_backend
    from repro_torch.core import queries as tq
    from repro_torch.core.packing import pack_masks
    from repro_torch.core.store import MASK_META_DTYPE
    from repro_torch.data import masks as masks_mod
    from repro_torch.kernels import ops, ref

    cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)
    rois = masks_mod.object_boxes(n, H, W, seed=1)
    meta = make_meta(n, MASK_META_DTYPE)
    provided = rois[meta["mask_id"]]
    sqls = packed_sql(tq)
    jobs = [(c, rois[s:s + CHUNK]) for c, s in enumerate(range(0, n, CHUNK))]
    workers = min(8, os.cpu_count() or 1)
    largest: dict = {}
    undo = record_largest(ops, PACKED_KERNELS + ("chi_cell_hist",), largest)

    # -- 6. the packed main path: ingest, indexed queries, naive scans (the
    # cp_count_packed path) and the scheduler's fused pass
    # data (set-up, not timed as ingest): bool chunks, 100 MB each
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        chunks = list(pool.map(binary_chunk, jobs))
    print(f"packed data: {n} binary masks {H}x{W} in "
          f"{time.perf_counter() - t0:.1f} s ({workers} worker processes)")
    ops.reset_launches()
    store, first, last = ingest(torch, MaskStore, cfg, dev, meta, chunks,
                                ops, packed=True)
    del chunks
    words_gb = store.device_masks().numel() * 4 / 1e9
    print(f"packed store: {n} masks {H}x{W} as {store.words} words a row, "
          f"{words_gb:.2f} GB of words and "
          f"{store.chi_table.numel() * 4 / 1e9:.2f} GB of finest CHI on the "
          f"card")
    results = run_queries(torch, tq, ops, store, sqls, provided, "packed ")
    naive = naive_scans(torch, tq, ops, store, sqls, provided)
    pos = np.arange(0, n, max(n // 4096, 1))[:4096]
    specs = fused_specs(provided[pos])
    fused = {}
    for be in ("device", "host"):
        t1 = time.perf_counter()
        fused[be] = get_backend(store, be).fused_counts(store, pos, specs)
        torch.cuda.synchronize()
        print(f"packed fused_counts backend={be}: {len(specs)} descriptors "
              f"x {len(pos)} masks in {time.perf_counter() - t1:.3f} s")
    packed_launches = ops.launch_counts()
    undo()
    print(f"packed path launches: {json.dumps(packed_launches)}")
    for k in PACKED_KERNELS + ("chi_cell_hist",):
        if packed_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the packed path")

    # ingest: the last appended chunk's words and CHI (built on the card)
    sample = slice(0, 64)
    at = n - len(last)
    want_words = pack_masks(last[sample]).view(np.int32)
    if not np.array_equal(
            store.device_masks()[at:at + 64].cpu().numpy(), want_words):
        fail("packed words on the card differ from pack_masks")
    if not np.array_equal(store.chi_host(np.arange(at, at + 64)),
                          build_chi_np(last[sample].astype(np.float32),
                                       cfg)):
        fail("packed ingest: CHI differs from build_chi_np")
    print("packed ingest check: last chunk's words and CHI equal pack_masks "
          "and build_chi_np on a 64-mask sample")

    check_answers(results, naive, sqls, "packed ")
    for qname, _ in sqls[:3]:
        for be in ("device", "host"):
            _, stats, launches = results[(qname, be)]
            if launches.get("fused_bounds_verify", 0) != stats.n_rounds:
                fail(f"packed {qname} on {be}: fused_bounds_verify launched "
                     f"{launches.get('fused_bounds_verify', 0)} times in "
                     f"{stats.n_rounds} verification rounds")
    res, stats, _ = results[("packed_refine", "device")]
    if len(res[0]) == 0 or stats.n_verified == 0:
        fail("packed_refine: empty answer or nothing verified")
    print("packed check: fused_bounds_verify launched once per verification "
          "round on every CP query and backend")
    if not np.array_equal(fused["device"], fused["host"]):
        fail("packed fused_counts: device and host differ")
    print("packed check: fused_counts identical on device and host")

    # the same queries on a float store of the first chunk's binary masks
    fl = MaskStore.create_memory(first.astype(np.float32), meta[:len(first)],
                                 cfg, device=dev)
    pk = MaskStore.create_memory(first, meta[:len(first)], cfg, packed=True,
                                 device=dev)
    for qname, sql in sqls:
        want, _ = tq.run(sql, fl, provided_rois=provided, backend="device")
        got, _ = tq.run(sql, pk, provided_rois=provided, backend="device")
        if not same_answer(got, want):
            fail(f"packed vs float store, first chunk: {qname} differs")
    print(f"packed check: the four queries on {len(first)} masks give the "
          f"same ids and scores from a packed and a float store")
    del store, results, naive, fl, pk

    # -- 7. the popcount kernels against their plain versions ---------------
    n_edge = packed_edge_cases(torch, ops, ref, pack_masks, dev)
    rate = card_popcount_rate(torch)
    largest["fused_bounds_verify"] = (0, fused_main_path_step(
        torch, ops, ref, largest[("fused_bounds_verify", "indexed")][1]))
    largest["cp_count_multi_packed"] = (0, multi_packed_main_path_step(
        torch, ops, ref, largest[("cp_count_multi_packed", "indexed")][1]))
    plain = {"cp_count_packed": ref.cp_count_packed_ref,
             "cp_count_multi_packed": ref.cp_count_multi_packed_ref,
             "mask_agg_counts_packed": ref.mask_agg_counts_packed_ref,
             "fused_bounds_verify": ref.fused_bounds_verify_ref}
    entries = [kernel_entry(
        torch, ops, name, largest[name][1], plain[name],
        packed_launches[name], n_edge[name],
        lambda name, a: packed_bound_of(torch, ref, name, a, rate),
        floor_ms if name == "fused_bounds_verify" else None)
        for name in PACKED_KERNELS]
    a = largest["chi_cell_hist"][1]
    hist = ops.chi_cell_hist(*a)
    if max_abs_err(torch, hist, ref.chi_cell_hist_ref(*a)) != 0:
        fail("chi_cell_hist differs from its plain version on binary masks")
    per_bin = hist.sum(dim=(0, 1, 2)).double() / a[0].numel()
    ms = time_ms(torch, lambda: ops.chi_cell_hist(*a))
    bound_ms, bound_by = bound_of(torch, ref, "chi_cell_hist", a)
    print(f"chi_cell_hist on binary masks: shape {tuple(a[0].shape)} equal, "
          f"{float(per_bin[0] + per_bin[-1]):.4f} of pixels in the first and "
          f"last bins; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {ms / bound_ms:.2f}x; "
          f"{packed_launches['chi_cell_hist']} launches on the packed path")
    return entries


def pair_bound_of(torch, ref, name, args, popc_per_s):
    """(bound_ms, bound_by, sector_ms) of a pair kernel call on its
    gathered batches: the ROI pixels (float) or the words the ROI touches
    (packed) of both masks read once, 16 B per ROI and 12 B of outputs per
    pair, over the HBM rate, against two compares and three adds per pixel
    pair over the f32 rate, or three popcounts per word pair over the
    card's popcount rate.  The sector floor moves the 32-byte sectors those
    pixels or words lie in instead, the same other bytes, over the HBM
    rate."""
    args = gathered(name, args)
    a = args[0]
    b, h, w = a.shape
    rois = torch.as_tensor(args[2]).to(a.device)
    if name == "pair_counts":
        px = int(roi_pixels(torch, rois, h, w).sum())
        nbytes = 2 * px * a.element_size() + b * 28
        t_ops = 5 * px / PEAK_F32_OPS_S * 1e3
        per = 32 // a.element_size()
        sectors = sum(sector_bytes(torch, ref._roi_mask(rois[i:i + 1024], h,
                                                        w), per)
                      for i in range(0, b, 1024))
    else:
        touched = touched_words(torch, rois, h, w)
        words = int(touched.sum())
        nbytes = 2 * words * 4 + b * 28
        t_ops = 3 * words / popc_per_s * 1e3
        sectors = sector_bytes(torch, touched, 8)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    sector_ms = (2 * sectors + b * 28) / PEAK_BYTES_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", sector_ms
    return t_ops, "operations", sector_ms


def pair_edge_cases(torch, ops, ref, pack_masks, dev):
    """Both pair kernels on the card against their plain versions, with
    tolerance 0: W = 33, 40, 64, 224 and 1100 (16-byte and element paths,
    tail bits), empty, unclipped and word-edge ROIs; for the float kernel
    f32 and bf16 masks with pixels and thresholds on the CHI bin edges
    k/16; for the packed one every (ta, tb) from {-0.5, 0, 0.5, 1, 1.5}."""
    vals = (-0.5, 0.0, 0.5, 1.0, 1.5)
    n_cases = dict.fromkeys(PAIR_KERNELS, 0)

    def check(name, got, want):
        n_cases[name] += 1
        if max_abs_err(torch, got, want) != 0:
            fail(f"{name} differs from its plain version on an edge case")

    for si, (b, h, w) in enumerate([(6, 16, 33), (6, 16, 40), (4, 224, 224),
                                    (5, 9, 64), (2, 5, 1100)]):
        rng = np.random.default_rng(500 + si)
        nw = (w + 31) // 32
        r = np.sort(rng.integers(0, h + 1, (b, 2)), axis=1)
        c = np.sort(rng.integers(0, w + 1, (b, 2)), axis=1)
        rois = np.stack([r[:, 0], c[:, 0], r[:, 1], c[:, 1]], 1)
        edges = [(0, 0, h, 64), (-3, -5, h + 2, 32 * nw + 9), (2, 3, 2, 20),
                 (1, 32, h, 64), (0, 31, h, 33), (1, 0, h - 1, 32)]
        rois[:min(b, len(edges))] = edges[:b]
        rois = torch.as_tensor(rois.astype(np.int32), device=dev)
        fa, fb = (rng.random((b, h, w), dtype=np.float32) for _ in range(2))
        for f in (fa, fb):
            pick = rng.random(f.shape) < 0.3
            f[pick] = (rng.integers(0, 17, pick.sum()) / 16).astype(np.float32)
        for dt in (torch.float32, torch.bfloat16):
            ma = torch.as_tensor(fa, device=dev).to(dt)
            mb = torch.as_tensor(fb, device=dev).to(dt)
            for ta, tb in ((0.5, 0.625), (0.6, 0.6), (0.8, 0.5), (0.0, 1.0)):
                check("pair_counts", ops.pair_counts(ma, mb, rois, ta, tb),
                      ref.pair_counts_ref(ma, mb, rois, ta, tb))
        pa, pb = (torch.as_tensor(pack_masks(rng.random((b, h, w)) < p).view(
            np.int32), device=dev) for p in (0.4, 0.5))
        for ta in vals:
            for tb in vals:
                check("pair_counts_packed",
                      ops.pair_counts_packed(pa, pb, rois, ta, tb),
                      ref.pair_counts_packed_ref(pa, pb, rois, ta, tb))
        # each role read in place through positions that repeat, run
        # backwards or are empty, on aligned and misaligned planes
        for wa, wb in ((pa, pb), (misaligned(torch, pa),
                                  misaligned(torch, pb))):
            for pos in ([b - 1, 0, b - 1, 0], list(range(b))[::-1], []):
                p = torch.tensor(pos, dtype=torch.int64, device=dev)
                args = (wa, wb, rois[p], 0.5, -0.5, p, p.flip(0))
                check("pair_counts_packed", ops.pair_counts_packed(*args),
                      ref.pair_counts_packed_ref(*args))
    torch.cuda.synchronize()
    return n_cases


def pair_phase(torch, dev, n_images, floor_ms):
    """Phases 8-9: the dual-mask pair operator on ``n_images`` images of
    (saliency, attention) masks, a float and a binary leg; returns the two
    pair kernels' ``kernels`` entries.  ``floor_ms`` is the launch floor,
    printed beside the packed pair kernel."""
    from repro_torch.core import CHIConfig, MaskStore, build_chi_np
    from repro_torch.core import queries as tq
    from repro_torch.core.packing import pack_masks
    from repro_torch.core.store import MASK_META_DTYPE
    from repro_torch.kernels import ops, ref

    cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)
    n = 2 * n_images
    boxes, _, jobs = pair_data(n_images)
    meta = make_meta(n, MASK_META_DTYPE)
    provided = np.repeat(boxes, 2, axis=0)
    sqls = pair_sql(tq, PAIR_T_DIFF, PAIR_T_RANKED)
    workers = min(8, os.cpu_count() or 1)

    # -- 8. the pair main path: ingest of both legs, indexed queries on both
    # backends and naive scans (set-up first: the data, not timed as ingest)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        parts = list(pool.map(pair_job, jobs))
    per = CHUNK // PAIR_JOB        # data jobs per 2,048-image ingest chunk
    chunks = {leg: [np.concatenate([p[i] for p in parts[s:s + per]])
                    for s in range(0, len(parts), per)]
              for i, leg in enumerate(("float", "packed"))}
    del parts
    print(f"pair data: {n_images} images x (saliency, attention), {n} float32 "
          f"masks {H}x{W} and their binary leg in "
          f"{time.perf_counter() - t0:.1f} s ({workers} worker processes)")
    largest: dict = {}
    undo = record_largest(ops, PAIR_KERNELS, largest)
    ops.reset_launches()
    legs = {}
    for leg in ("float", "packed"):
        store, first, last = ingest(torch, MaskStore, cfg, dev, meta,
                                    chunks[leg], ops, packed=leg == "packed")
        results = run_queries(torch, tq, ops, store, sqls, provided,
                              f"pair {leg} ")
        legs[leg] = (store, first, last, results,
                     naive_scans(torch, tq, ops, store, sqls, provided))
    pair_launches = ops.launch_counts()
    undo()
    del chunks
    print(f"pair path launches: {json.dumps(pair_launches)}")
    for k in PAIR_KERNELS + ("chi_cell_hist",):
        if pair_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the pair path")

    for leg, (store, first, last, results, naive) in legs.items():
        at = len(store) - len(last)
        if not np.array_equal(store.chi_host(np.arange(at, at + 64)),
                              build_chi_np(last[:64].astype(np.float32),
                                           cfg)):
            fail(f"pair {leg} ingest: CHI differs from build_chi_np")
        check_answers(results, naive, sqls, f"pair {leg} ")
        # every query has one (ta, tb, roi) spec: one launch per round; a
        # naive scan is one pass over all pairs, two for the filtered
        # ranking (its predicate, then the ranking of the survivors)
        kernel = "pair_counts_packed" if store.packed else "pair_counts"
        rounds = 0
        for qname, _ in sqls:
            passes = 2 if qname == "pair_filtered_topk" else 1
            if naive[qname][3][kernel] != passes:
                fail(f"pair {leg} {qname} naive scan: {kernel} launched "
                     f"{naive[qname][3][kernel]} times, not {passes}")
            for be in ("device", "host"):
                res, stats, launches = results[(qname, be)]
                if launches.get(kernel, 0) != stats.n_rounds:
                    fail(f"pair {leg} {qname} on {be}: {kernel} launched "
                         f"{launches.get(kernel, 0)} times in "
                         f"{stats.n_rounds} verification rounds")
                rounds += stats.n_rounds
                ids = res[0] if isinstance(res, tuple) else res
                if len(ids) == 0 or stats.n_verified == 0:
                    fail(f"pair {leg} {qname} on {be}: empty answer or "
                         f"nothing verified")
        scans = sum(naive[q][3][kernel] for q, _ in sqls)
        if pair_launches[kernel] != rounds + scans:
            fail(f"pair {leg}: {kernel} launched {pair_launches[kernel]} "
                 f"times for {rounds} rounds and {scans} naive passes")
        print(f"pair {leg} check: ingest CHI equals build_chi_np on a sample; "
              f"{kernel} launched once per verification round ({rounds}) and "
              f"naive pass ({scans}); every answer non-empty with a "
              f"verified residue")

    # the binary leg's first chunk as a packed and as a float store
    first = legs["packed"][1]
    fl = MaskStore.create_memory(first.astype(np.float32), meta[:len(first)],
                                 cfg, device=dev)
    pk = MaskStore.create_memory(first, meta[:len(first)], cfg, packed=True,
                                 device=dev)
    for qname, sql in sqls:
        want, _ = tq.run(sql, fl, provided_rois=provided, backend="device")
        got, _ = tq.run(sql, pk, provided_rois=provided, backend="device")
        if not same_answer(got, want):
            fail(f"pair packed vs float store, first chunk: {qname} differs")
    print(f"pair check: the four queries on {len(first) // 2} images give the "
          f"same ids and scores from a packed and a float store")
    del legs, fl, pk

    # -- 9. the pair kernels against their plain versions ------------------
    n_edge = pair_edge_cases(torch, ops, ref, pack_masks, dev)
    rate = card_popcount_rate(torch)
    pair_main_path_step(torch, ops, ref,
                        largest[("pair_counts_packed", "indexed")][1])
    plain = {"pair_counts": ref.pair_counts_ref,
             "pair_counts_packed": ref.pair_counts_packed_ref}
    return [kernel_entry(
        torch, ops, name, largest[name][1], plain[name], pair_launches[name],
        n_edge[name], lambda name, a: pair_bound_of(torch, ref, name, a, rate),
        floor_ms if name == "pair_counts_packed" else None)
        for name in PAIR_KERNELS]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import CHIConfig, MaskStore, build_chi_np
    from repro_torch.core import queries as tq
    from repro_torch.core.store import MASK_META_DTYPE
    from repro_torch.data import masks as masks_mod
    from repro_torch.kernels import cuda_lib, ops, popcount, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n = N_MASKS

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s; " + "; ".join(
        f"{k}: {p}" for k, (p, _) in sorted(built.items())))
    for name, (_, log) in sorted(built.items()):
        regs = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        for ln in regs:
            print(f"ptxas {name}: {ln}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    # the device time of a launch that does nothing: the floor under the
    # small calls (the megakernel's batches, the pair rounds)
    floor_ms = time_ms(torch, lambda: popcount.empty_launch(dev))
    print(f"launch floor: empty kernel {floor_ms:.4f} ms ({smi})")

    # -- data (set-up, not timed as ingest) ---------------------------------
    t0 = time.perf_counter()
    masks, rois = make_data(n, H, W, masks_mod)
    meta = make_meta(n, MASK_META_DTYPE)
    print(f"data: {n} masks {H}x{W} float32 "
          f"({masks.nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)

    # record each kernel's largest main-path call, for the parity phase
    largest: dict = {}
    undo = record_largest(ops, FLOAT_KERNELS, largest)

    # -- 2-3. the main path: ingest + indexed queries -----------------------
    ops.reset_launches()
    store, _, _ = ingest(torch, MaskStore, cfg, dev, meta,
                      (masks[s:s + CHUNK] for s in range(0, n, CHUNK)),
                      ops, packed=False)
    provided = rois[meta["mask_id"]]
    results = run_queries(torch, tq, ops, store, sql_set(tq), provided, "")
    main_launches = ops.launch_counts()
    undo()
    for k in FLOAT_KERNELS:
        if main_launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # ingest check: appended CHI chunks against the numpy oracle
    for c, chunk in enumerate(store.chi_chunks[1:], start=1):
        lo = c * CHUNK
        sample = slice(0, 64)
        want = build_chi_np(masks[lo:lo + CHUNK][sample], cfg)
        if not np.array_equal(chunk[sample], want):
            fail(f"CHI chunk {c} differs from build_chi_np")
    print(f"ingest check: {len(store.chi_chunks) - 1} appended CHI chunks "
          f"equal build_chi_np on 64-mask samples")

    # device == host, and both == the naive scan
    naive = naive_scans(torch, tq, ops, store, sql_set(tq), provided)
    check_answers(results, naive, sql_set(tq), "")

    # -- 4. kernels against their plain versions ----------------------------
    n_edge = edge_cases(torch, ops, ref)
    largest["cp_count_multi"] = (0, multi_main_path_step(
        torch, ops, ref, largest["cp_count_multi"][1]))
    plain = {"cp_count": ref.cp_count_ref,
             "cp_count_multi": ref.cp_count_multi_ref,
             "chi_cell_hist": ref.chi_cell_hist_ref,
             "mask_agg_counts": ref.mask_agg_counts_ref}
    kernels = [kernel_entry(torch, ops, name, largest[name][1], plain[name],
                            main_launches[name], n_edge[name],
                            lambda name, a: bound_of(torch, ref, name, a))
               for name in FLOAT_KERNELS]

    # -- 5. a small store: card vs CPU --------------------------------------
    sm_masks, sm_rois = make_data(64, 64, 64, masks_mod)
    sm_meta = make_meta(64, MASK_META_DTYPE)
    sm_cfg = CHIConfig(grid=16, num_bins=16, height=64, width=64)
    stores = {}
    for d in ("cuda", "cpu"):
        s = MaskStore.create_memory(sm_masks[:32], sm_meta[:32], sm_cfg,
                                    device=d)
        s.append(sm_masks[32:], sm_meta[32:])
        stores[d] = s
    if not np.array_equal(stores["cuda"].chi_host(), stores["cpu"].chi_host()):
        fail("small store: CHI built on the card differs from the CPU build")
    # its masks alternate types 1 and 2 per image: a pair store too, and
    # binarised, a packed pair store
    sm_sqls = sql_set(tq) + pair_sql(tq, 20, 40)
    sm_bin = (sm_masks > 0.5).astype(np.float32)
    for d in ("cuda", "cpu"):
        stores["packed " + d] = MaskStore.create_memory(
            sm_bin, sm_meta, sm_cfg, packed=True, device=d)
    for kind, sqls in (("", sm_sqls), ("packed ", pair_sql(tq, 20, 40))):
        for qname, sql in sqls:
            want, _ = tq.run(sql, stores[kind + "cpu"],
                             provided_rois=sm_rois, backend="host")
            for be in ("device", "host"):
                got, _ = tq.run(sql, stores[kind + "cuda"],
                                provided_rois=sm_rois, backend=be)
                if not same_answer(got, want):
                    fail(f"small {kind}store {qname} on {be}: card differs "
                         f"from CPU")
    print(f"small store: 64 masks 64x64 (32 saliency/attention pairs), "
          f"{len(sm_sqls)} queries (four pair queries among them), and the "
          f"four pair queries on a packed store of the same masks binarised, "
          f"identical on the card (device and host backends) and on the CPU")
    del store, masks, results, largest, stores
    torch.cuda.empty_cache()

    # -- 6-7. the packed path, then its kernels -----------------------------
    kernels += packed_phase(torch, dev, N_PACKED, floor_ms)
    torch.cuda.empty_cache()

    # -- 8-9. the pair operator, then its kernels ---------------------------
    kernels += pair_phase(torch, dev, N_PAIRS, floor_ms)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
