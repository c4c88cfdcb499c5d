#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py      # 16,384 float32 + 65,536 binary masks,
                               # 8,192 (saliency, attention) pairs and
                               # 4,096 masks from granite-3.0-2B, 224x224,
                               # then granite-3.0-2B trained at full width,
                               # then recurrentgemma-2b, mamba2-1.3b,
                               # whisper-large-v3 and deepseek-v2-236b
                               # (8 of 60 layers) serving and making masks,
                               # then the dry-run, the MaskSearch mesh
                               # cells and granite on a (1, 1) mesh

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
   versions) and require identical answers; then serve the float store
   with the query service on the device backend (``MaskSearchService``
   behind the threaded HTTP server): the four queries one-shot (first and
   repeat, the repeat a cache hit that loads nothing) equal to phase 3 and
   the naive scans, a paged session equal to the one-shot ``LIMIT 100``, a
   fused ``/workload`` of 8 overlapping CP rankings, ``EXPLAIN ANALYZE``
   against ``ExecStats``, 4 tenants x 16 requests on the async tier, an
   ingest of 2,048 masks and an update of 64 of them (then queries equal
   to the naive scan of the grown store), and ``/metrics`` through
   ``benchmarks/check_prometheus.py``;
6. the packed path: 65,536 binary masks (``saliency_masks > 0.5``, made
   chunk by chunk in worker processes) ingested into a packed ``MaskStore``
   on the card, the packed filter, top-k and refine queries and
   ``SCENARIO3_IOU`` on the device and host backends and as naive scans,
   and one ``fused_counts`` pass per backend; device == host == naive scan,
   ``fused_bounds_verify`` launched once per verification round, and the
   same queries on a float store of the first chunk give the packed
   store's answers; then the packed store behind the service: the packed
   filter, top-k and ``SCENARIO3_IOU`` one-shot and a ``/workload`` of 8
   overlapping packed CP rankings, with the fused passes' descriptors per
   pass;
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
   packed store's answers; then each leg behind the service with a
   ``/workload`` of the four pair queries, equal to the engine's answers;
9. the two pair kernels against their plain versions (main-path inputs and
   edge cases, tolerance 0) and timed beside their bounds and sector
   floors; ``pair_counts_packed`` also as a device round runs it (both
   roles read in place) against the two gathers it replaced;
10. the mask producers: granite-3.0-2B at full width (40 layers, d_model
   2048, bf16, random weights from ``torch.Generator`` seed 0) built with
   ``build_model``; ``launch/serve.py``'s prefill of 8 x 128 tokens and 32
   greedy decode steps; a two-layer float32 cut at full width held to
   teacher forcing and, with the same weights, to the port's CPU path;
   4,096 224x224 last-layer attention masks harvested from
   ``SyntheticLMData`` through ``PrefetchIterator`` and one batch of
   input saliency through the whole stack; the masks ingested on the
   card (``create_memory`` of 2,048, ``append`` of the rest) and queried
   with Scenario 1's ranking and a CP filter over the span's key columns
   on the device and host backends and as naive scans (device == host ==
   naive scan, equal ``ExecStats``) in a launch window of their own
   (``producer launches``), whose largest ``chi_cell_hist``,
   ``cp_count_multi`` and ``cp_count`` calls are then held against their
   plain versions (``producer parity``); then the top-k's masks are
   augmented outside their ROI and their token rows redrawn and mixed
   into a batch (``producer …`` lines);
11. training: ``launch/train.py``'s ``run`` (the CLI's ``main`` as a
   library call) trains granite-3.0-2B at full width from random weights
   (generator seed 0; ``wq`` and ``wk`` at 1/8 of the init scale, since
   at the init's own scale the f32 grad norm overflows at 40 layers) for
   3 steps of 4 x 4,096 ``SyntheticLMData`` tokens
   in 2 microbatches, AdamW with fp32 master weights: loss, grad norm,
   lr, step ms, tok/s, MFU, optimizer ms and peak memory per step, every
   loss and grad norm finite (``train …`` lines); Scenario 1's loop
   continues from that model and optimizer state: 1,024 last-layer
   attention masks harvested, indexed (``create_memory`` of 512,
   ``append`` of 512) and queried with phase 10's two queries on both
   backends and as naive scans in a launch window of its own (``loop
   launches``; device == host == naive scan, equal ``ExecStats``), the
   window's largest ``chi_cell_hist``, ``cp_count_multi`` and ``cp_count``
   calls held against their plain versions (``loop parity``), the
   ranking's rows redrawn with ``mix_augmented`` and mixed in through
   ``AugmentedData``, 2 retrain steps of 64 x 224, and the probe harvested
   again (``loop …`` lines); then at a two-layer float32 cut at full
   width: one train step on the card against the CPU, ``rms_norm``'s
   hand-written VJP against autograd of the plain forward, and a resume
   from a checkpoint against the uninterrupted run (``train check``
   lines); last, ``examples/scenario1_debugging_torch.py`` at its own size
   on the card (``scenario1 example`` lines);
12. the other producers: recurrentgemma-2b (26 layers, RG-LRU and local
   MQA), mamba2-1.3b (48 SSD layers) and whisper-large-v3 (32 + 32
   layers) at full width and depth in bf16 (random weights, generator
   seed 0), one after another: ``launch/serve.py``'s prefill (8 x 128
   tokens; whisper 8 x 1,500 frames and 16 tokens) and 32 greedy decode
   steps beside the decode bound (the bytes of the weights, caches and
   states a step reads at 3.35 TB/s); a float32 cut at full width
   (recurrentgemma 3 layers, mamba2 2, whisper 2 + 2) held to teacher
   forcing and to the CPU; masks made as each family's source makes them
   (recurrentgemma: 4,096 attention maps of its last local layer;
   mamba2: 1,024 input-saliency grids, ``attention_maps`` being ``None``;
   whisper: 1,024 cross-attention maps of 448 tokens x 1,500 frames,
   resized to 224x224), then phase 10's index-and-query window over them
   (``other <model> launches`` and ``other <model> parity`` lines);
13. the DeepSeek family: deepseek-v2-236b at full width (d_model 5120,
   128 MLA heads, 160 routed experts top-6 + 2 shared, vocab 102,400;
   bf16, random weights from generator seed 0 at the reference's init
   scales) with its depth cut to 8 layers, 1 dense + 7 MoE (28.67 B
   parameters, 57.33 GB), serves ``launch/serve.py``'s prefill of 8 x 128
   tokens and 32 greedy decode steps beside the decode bound (each step
   reads every expert of every layer: the reference's capacity dispatch
   runs all 160 at capacity 1); 2,048 224x224 expert-utilisation masks
   are harvested from layer 7's router (``router_probs`` of 224-token
   ``SyntheticLMData`` sequences, 32 a batch, then
   ``expert_utilization_map``) and go through phase 10's index-and-query
   window (``deepseek launches`` and ``deepseek parity`` lines); then a
   2-layer float32 cut (1 dense + 1 MoE) on the card against the port's
   CPU path at the configs' own capacity (assignments drop on both), and
   at capacity factor 100 against teacher forcing (``deepseek check``);
   last, deepseek-v3-671b at full width cut to 4 layers (3 dense + 1 MoE)
   and its multi-token-prediction head (25.79 B parameters): a prefill of
   8 x 128 and one ``loss`` of 4 x 512 tokens with ``labels_mtp`` (``ce``,
   ``aux``, ``ce_mtp``, ``loss`` finite);
14. the mesh (``mesh …`` and ``dryrun …`` lines): ``python -m
   repro_torch.launch.dryrun`` over every config x shape on the 256- and
   512-rank meshes (no cost), granite_3_2b/train_4k with its FLOP count
   and the MaskSearch cells, four processes side by side (no cell may
   fail; cells over 80 GB a rank are printed); then the dry-run's four
   MaskSearch cells through ``core/distributed.py``'s steps on a (1,)
   mesh of ``cuda:0``, one at a time on data drawn on the card:
   ``verify_64k`` at the reference's 65,536 x 256x256 masks,
   ``filter_bounds`` and ``topk_bounds`` over 2,097,152 CHI rows (cut from
   4,194,304: 16,384 masks' tables built with ``chi_cell_hist`` and tiled
   128x; answers on the first 16,384 rows equal to the host's bounds,
   counts 128x theirs) and ``iou_agg`` at 65,536 groups (cut from
   262,144), each timed beside its bytes over 3.35 TB/s, with
   ``cp_count`` and ``mask_agg_counts`` held against their plain versions
   at tolerance 0; the expert-parallel bytes a rank sends in a train
   step on a 2 x 4 and a 16 x 16 mesh (``mesh ep reckoned`` lines,
   ``sharding.ep_bytes``); last, on a (1, 1) ("data", "model")
   ``DeviceMesh``: granite-3.0-2B at full width, greedy decode of 8 x 128
   + 8 steps with the cache placed by ``cache_sharding_tree`` (tokens
   equal to the unsharded decode), phase 11's train step sharded against
   unsharded (loss within 1e-3 relative), 2 sharded steps (ms, peak GB),
   and a 2-layer float32 cut's updated parameters against the unsharded
   step's (``params_within_rule``); deepseek-v2-236b at phase 13's 8
   layers, the same decode (tokens equal), and a 2-layer float32 cut's
   loss and gradients against unsharded (1e-5 of scale); recurrentgemma-
   2b, mamba2-1.3b and whisper-large-v3 at full width, the same decode on
   phase 12's prompts (tokens equal); and at granite's 2-layer float32
   cut, 2 steps on the mesh, a checkpoint saved from it and restored on
   one device (every leaf equal), a third step there, equal to 3
   uninterrupted steps (``mesh decode``, ``mesh train`` and ``mesh
   ckpt`` lines with ms and peak GB).

Kernel launch counters are zeroed just before each main path (phases 2-3,
indexed queries only; phases 6 and 8, naive scans included, since they
carry ``cp_count_packed`` and the pair kernels' largest calls) and read
just after it; every kernel of that path must have been launched there.
Each service window (float, packed, pair) is a path of its own: its
counters are zeroed at its start, printed on a ``service launches`` line
at its end, and every kernel the service runs there must have launched.
The engine runs and naive scans that a window's answers are held to run
before it opens or after it closes, so its counts are the service's own.
Each store (the float store before its service window grows it, the
packed store, both pair legs) also runs on the mesh backend in a launch
window of its own (``mesh launches`` lines): its indexed queries on a mesh
of every visible GPU and on four logical shards of ``cuda:0`` (padding and
per-shard uploads on the card), each answer and ``ExecStats`` equal to the
device backend's and the naive scan's, with mesh, device and host seconds
and the bytes each query uploads; then one ``/workload`` through
``MaskSearchService(store, backend="mesh")``; the float and packed
stores also run one ``fused_counts`` pass on each mesh.  Every kernel the
code routes these queries to must launch in that window, and each mesh's
largest per-shard call of each such kernel is held against the kernel's
plain version at tolerance 0 once the window closes (``mesh parity``
lines).
The script prints the build, the card, the launch floor (the device time
of an empty kernel), per-query times and stats, a
``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the
repository's ``src/`` beside it; without either it exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import threading
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

# the producer phase: granite-3.0-2B at full width (random weights)
PRODUCER_ARCH = "granite_3_2b"
N_PRODUCED = 4096           # 224-token sequences → 224x224 attention masks
PRODUCER_BATCH = 64
N_PRODUCED_FIRST = 2048     # create_memory on these, append the rest
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 8, 128, 32
PRODUCER_ROI = (0, 56, 224, 168)    # the key columns of the object span
PRODUCER_LIMIT = 256        # the ranking's LIMIT
PRODUCER_KERNELS = ("chi_cell_hist", "cp_count_multi", "cp_count")
PEAK_BF16_OPS_S = 989e12    # H100 SXM dense bf16 tensor cores

# the other producers (phase 12): the recurrent and encoder-decoder
# families at full width and depth (random weights)
OTHER_ARCHS = ("recurrentgemma_2b", "mamba2_13b", "whisper_large_v3")
# each one's parameters at full width: jax.eval_shape of the JAX package's
# init (tests/test_torch_recurrent.py and test_torch_encdec.py hold the
# port's count and every leaf's shape to it)
OTHER_PARAMS = {"recurrentgemma_2b": 2_894_481_920,
                "mamba2_13b": 1_343_790_080,
                "whisper_large_v3": 1_534_732_800}
OTHER_MASKS = {"recurrentgemma_2b": 4096, "mamba2_13b": 1024,
               "whisper_large_v3": 1024}
OTHER_BATCH = {"recurrentgemma_2b": 64, "mamba2_13b": 64,
               "whisper_large_v3": 16}
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 16     # its 30-s window; a prompt

# the DeepSeek family (phase 13): full width, depth cut to fit one card;
# the parameter counts are jax.eval_shape's of the JAX package's init at
# these depths (tests/test_torch_deepseek.py holds the port's full-depth
# counts and leaf shapes to it)
DEEPSEEK_ARCH = "deepseek_v2_236b"
DEEPSEEK_LAYERS = 8         # 1 dense + 7 MoE
DEEPSEEK_PARAMS = 28_667_089_920
DEEPSEEK_V3_ARCH = "deepseek_v3_671b"
DEEPSEEK_V3_LAYERS = 4      # 3 dense + 1 MoE, and the MTP head
DEEPSEEK_V3_PARAMS = 25_794_476_032
N_EXPERT_MASKS = 2048       # 224-token sequences → 224x224 masks
EXPERT_BATCH = 32

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


def ingest(torch, MaskStore, cfg, dev, meta, chunks, ops, packed,
           label=None):
    """``create_memory`` on the first chunk, then ``append`` of the rest,
    each call timed to its end on the card.  Returns the store, the first
    chunk and the last."""
    label = label or ("packed ingest" if packed else "ingest")
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
    wall time, ``ExecStats`` and kernel launches of each run, and returns
    (answer, stats, launches, seconds) per (query, backend)."""
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
            results[(qname, be)] = (res, stats, launches, wall)
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
        rd, sd, _, _ = results[(qname, "device")]
        rh, sh, _, _ = results[(qname, "host")]
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


def fused_positions(n):
    """The masks of a ``fused_counts`` pass: 4,096 spread over ``n``."""
    return np.arange(0, n, max(n // 4096, 1))[:4096]


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


def packed_phase(torch, dev, n, floor_ms, smi):
    """Phases 6-7: the packed path on ``n`` binary masks; returns the four
    popcount kernels' ``kernels`` entries.  ``floor_ms`` is the launch
    floor, printed beside the megakernel; ``smi`` the card's name and power
    limit."""
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
    pos = fused_positions(n)
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
            _, stats, launches, _ = results[(qname, be)]
            if launches.get("fused_bounds_verify", 0) != stats.n_rounds:
                fail(f"packed {qname} on {be}: fused_bounds_verify launched "
                     f"{launches.get('fused_bounds_verify', 0)} times in "
                     f"{stats.n_rounds} verification rounds")
    res, stats, _, _ = results[("packed_refine", "device")]
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
    del fl, pk
    mesh_phase(torch, tq, ops, "packed", {"": (
        store, results, naive,
        workload_answers(tq, store, packed_service_sqls(), provided))},
        provided, sqls, packed_service_sqls(), smi, fused=(pos, specs))
    service_packed_phase(tq, ops, store, provided, sqls, results, naive)
    del store, results, naive

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


def pair_phase(torch, dev, n_images, floor_ms, smi):
    """Phases 8-9: the dual-mask pair operator on ``n_images`` images of
    (saliency, attention) masks, a float and a binary leg; returns the two
    pair kernels' ``kernels`` entries.  ``floor_ms`` is the launch floor,
    printed beside the packed pair kernel; ``smi`` the card's name and
    power limit."""
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
                res, stats, launches, _ = results[(qname, be)]
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
    del fl, pk
    mesh_phase(torch, tq, ops, "pair", {
        leg: (store, results, naive,
              [results[(qname, "device")][0] for qname, _ in sqls])
        for leg, (store, _, _, results, naive) in legs.items()},
        provided, sqls, [sql for _, sql in sqls], smi)
    service_pair_phase(tq, ops, legs, provided, sqls)
    del legs

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


# -- the query service on the card ---------------------------------------------

def serve_http(service):
    """The threaded HTTP front on port 0 → (httpd, thread, base url)."""
    from repro_torch.service import make_server
    httpd = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    return httpd, thread, f"http://{host}:{port}"


def stop_http(httpd, thread) -> None:
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def timed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def payload_is(payload, want) -> bool:
    """A service JSON payload's ids (and scores) equal an engine answer."""
    if isinstance(want, tuple):
        return (payload["ids"] == np.asarray(want[0]).tolist() and
                payload["scores"] == np.asarray(want[1],
                                                np.float64).tolist())
    return payload["ids"] == np.asarray(want).tolist()


def fused_passes(service, name="scheduler.fused_pass") -> list:
    """(descriptors, union masks or pairs) of each fused pass in the
    service's last trace."""
    return [(sp.attrs["descriptors"],
             sp.attrs.get("union_masks", sp.attrs.get("union_pairs")))
            for sp in service.tracer.last_trace().walk() if sp.name == name]


def q_histogram(passes) -> str:
    counts: dict = {}
    for q, _ in passes:
        counts[q] = counts.get(q, 0) + 1
    return ", ".join(f"Q={q}: {n}" for q, n in sorted(counts.items()))


def close_window(ops, label, needed, t0, kind="service") -> None:
    """Read the launch counters a service or mesh window zeroed at its
    start; every kernel of ``needed`` must have launched in it."""
    counts = ops.launch_counts()
    print(f"{kind} launches {label}: "
          + json.dumps({k: v for k, v in counts.items() if v}))
    for k in needed:
        if counts[k] <= 0:
            fail(f"kernel {k} was not launched in the {label} {kind} window")
    print(f"{kind} phase {label}: {time.perf_counter() - t0:.1f} s")


def workload_answers(tq, store, sqls, rois) -> list:
    """The engine's one-shot answer to each of ``sqls`` on the device
    backend: the references of a /workload, computed outside the service
    window so that its launch counts are the service's own."""
    return [tq.run(sql, store, provided_rois=rois, backend="device")[0]
            for sql in sqls]


def check_workload(client, sqls, wants, label) -> None:
    """A /workload of ``sqls``: each answer equals its one-shot answer
    ``wants`` (from ``workload_answers``)."""
    out, secs = timed(client.workload, sqls)
    for sql, payload, want in zip(sqls, out, wants):
        if not payload_is(payload, want):
            fail(f"{label} workload: {sql!r} differs from its one-shot answer")
    print(f"{label} workload: {len(sqls)} queries in {secs:.3f} s, each "
          f"equal to its one-shot answer")


def float_sqls() -> list:
    """8 overlapping CP rankings for the /workload: the per-mask box at
    four value ranges, the full image at two, two rankings by area share."""
    cp = "SELECT mask_id FROM MasksDatabaseView ORDER BY "
    return ([f"{cp}CP(mask, roi, ({lv}, 1.0)) / AREA(roi) ASC LIMIT 25;"
             for lv in (0.6, 0.7, 0.8, 0.9)]
            + [f"{cp}CP(mask, full_img, ({lv}, 0.6)) DESC LIMIT 25;"
               for lv in (0.2, 0.3)]
            + [f"{cp}CP(mask, roi, (0.5, 1.0)) DESC LIMIT 40;",
               f"{cp}CP(mask, full_img, (0.8, 1.0)) ASC LIMIT 25;"])


def tenant_sql(t, i) -> str:
    """Request ``i`` of tenant ``t``: a ranking no other request sends."""
    return ("SELECT mask_id FROM MasksDatabaseView ORDER BY CP(mask, roi, "
            f"({0.5 + 0.025 * i:.3f}, 1.0)) / AREA(roi) ASC "
            f"LIMIT {20 + t};")


def tenant_load(base, n_tenants, n_requests):
    """``n_tenants`` threads, each sending ``n_requests`` queries to the
    async tier under its own X-Tenant → ({(t, i): ids}, latencies s)."""
    import urllib.request
    answers: dict = {}
    lat: list = []
    lock = threading.Lock()

    def tenant(t):
        for i in range(n_requests):
            req = urllib.request.Request(
                base + "/v1/query",
                data=json.dumps({"sql": tenant_sql(t, i)}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Tenant": f"tenant-{t}"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                body = json.loads(resp.read())
            with lock:
                lat.append(time.perf_counter() - t0)
                answers[(t, i)] = body
    threads = [threading.Thread(target=tenant, args=(t,))
               for t in range(n_tenants)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if len(answers) != n_tenants * n_requests:
        fail("concurrent service load: a tenant thread failed")
    return answers, lat


def service_float_phase(torch, tq, ops, masks_mod, store, rois, results,
                        naive, smi):
    """The float store behind the service, on the device backend: the main
    queries one-shot over HTTP (first and repeat), a paged session, a
    fused /workload, EXPLAIN ANALYZE, 4 tenants x 16 requests on the async
    tier, an ingest of 2,048 masks and an update of 64, and the /metrics
    text; one launch window.  The engine runs and naive scans that the
    service's answers are held to run outside the window (before it, or
    after it for the grown store), so its counts are the service's own."""
    from repro_torch.core import build_chi_np
    from repro_torch.service import MaskSearchService, ServiceClient
    from repro_torch.service.asyncserver import serve_in_thread

    n = len(store)
    n_new = CHUNK
    new_rois = masks_mod.object_boxes(n_new, H, W, seed=12)
    new, _ = masks_mod.saliency_masks(n_new, H, W, seed=11,
                                      attacked_fraction=0.15, boxes=new_rois)
    # default ROIs for the masks to come too (positions index them)
    all_rois = np.concatenate([rois, new_rois])
    workload_wants = workload_answers(tq, store, float_sqls(), all_rois)
    tenant_wants = {(t, i): tq.run(tenant_sql(t, i), store,
                                   provided_rois=all_rois,
                                   backend="device")[0]
                    for t in range(4) for i in range(16)}
    t0 = time.perf_counter()
    ops.reset_launches()
    service = MaskSearchService(store, provided_rois=all_rois,
                                backend="device", trace=True)
    httpd, thread, base = serve_http(service)
    client = ServiceClient(base, timeout=600)

    for qname, sql in sql_set(tq):
        first, t_first = timed(client.query, sql)
        repeat, t_rep = timed(client.query, sql)
        want = results[(qname, "device")][0]
        if not (payload_is(first, want) and payload_is(first,
                                                       naive[qname][0])):
            fail(f"service {qname}: answer differs from the engine's and "
                 f"the naive scan's")
        if not (repeat["cache_hit"] and repeat["stats"]["bytes_loaded"] == 0
                and repeat["ids"] == first["ids"]):
            fail(f"service {qname}: the repeat is not a zero-load cache hit")
        print(f"service query {qname}: first {t_first:.3f} s, repeat "
              f"{t_rep:.3f} s (cache hit, 0 bytes loaded); "
              f"{len(first['ids'])} ids equal to phase 3 and the naive scan, "
              + json.dumps({k: first["stats"][k] for k in (
                  "n_candidates", "n_decided_by_bounds", "n_verified",
                  "n_rounds")}))

    # a paged session concatenates to the one-shot LIMIT 4k
    k = 25
    sess = client.query(tq.SCENARIO2_TOPK, session=True, page_size=k)
    pages = [sess["page"]["ids"]]
    for _ in range(3):
        sess = client.next_page(sess["session"])
        pages.append(sess["page"]["ids"])
    whole = client.query(tq.SCENARIO2_TOPK.replace(f"LIMIT {k}",
                                                   f"LIMIT {4 * k}"))
    if sum(pages, []) != whole["ids"]:
        fail("service session: 4 pages differ from the one-shot LIMIT 100")
    print(f"service session: 4 pages of {k} equal the one-shot LIMIT {4 * k}")

    s0 = service.scheduler.stats.as_dict()
    check_workload(client, float_sqls(), workload_wants, "service float")
    s1 = service.scheduler.stats.as_dict()
    passes = fused_passes(service)
    d = {f: s1[f] - s0[f] for f in ("rounds", "fused_passes",
                                    "fused_descriptors", "fused_masks")}
    print(f"service float workload scheduler: {json.dumps(d)}; descriptors "
          f"per pass {q_histogram(passes)}; union masks per pass "
          f"{[m for _, m in passes]}")

    rep = client.query("EXPLAIN ANALYZE " + tq.SCENARIO1_TOPK)
    st = rep["tree"]["stats"]
    want = results[("scenario1_topk", "device")][1]
    got = (st["candidates"], st["decided_by_bounds"], st["verified"])
    if got != (want.n_candidates, want.n_decided_by_bounds, want.n_verified):
        fail(f"EXPLAIN ANALYZE scenario1_topk: {got} differs from ExecStats")
    print(f"service EXPLAIN ANALYZE scenario1_topk: candidates, decided by "
          f"bounds, verified {got} equal to the run's ExecStats")

    # 4 tenants x 16 requests on the async tier, from threads
    handle = serve_in_thread(service)
    c0 = service.scheduler.stats.cross_tenant_passes
    (answers, lat), secs = timed(tenant_load, handle.base_url, 4, 16)
    handle.stop()
    for (t, i), body in answers.items():
        if not payload_is(body, tenant_wants[(t, i)]):
            fail(f"async tier: tenant {t} request {i} differs from its "
                 f"one-shot answer")
    p50, p95 = np.percentile(np.asarray(lat) * 1e3, [50, 95])
    print(f"service async tier: 4 tenants x 16 requests in {secs:.3f} s, "
          f"each equal to its one-shot answer; request latency p50 "
          f"{p50:.1f} ms, p95 {p95:.1f} ms; cross-tenant fused passes "
          f"{service.scheduler.stats.cross_tenant_passes - c0} ({smi})")

    # ingest a chunk, then replace 64 of its rows
    ids = np.arange(n, n + n_new)
    out, t_app = timed(service.ingest, new, mask_ids=ids, image_ids=ids // 2,
                       mask_types=ids % 2 + 1)
    torch.cuda.synchronize()
    upd, t_upd = timed(service.ingest, new[64:128], mask_ids=ids[:64],
                       on_conflict="update")
    torch.cuda.synchronize()
    if (out["appended"], upd["updated"], len(store)) != (n_new, 64,
                                                         n + n_new):
        fail(f"service ingest: {out}, {upd}")
    pos = np.arange(n, n + 64)
    if not np.array_equal(store.device_masks()[n:n + 64].cpu().numpy(),
                          new[64:128]):
        fail("service update: the card's rows differ from the new masks")
    if not np.array_equal(store.chi_host(pos), build_chi_np(new[64:128],
                                                            store.cfg)):
        fail("service update: CHI rows differ from build_chi_np")
    grown = {qname: (sql, client.query(sql)) for qname, sql in (
        ("scenario1_topk", tq.SCENARIO1_TOPK),
        ("scenario2_topk", tq.SCENARIO2_TOPK))}
    print(f"service ingest: append of {n_new} masks {t_app:.3f} s, update "
          f"of 64 rows {t_upd:.3f} s (epoch {upd['epoch']}); updated rows and "
          f"CHI on the card equal the new masks")

    text = client.metrics()
    check = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks",
                                      "check_prometheus.py"),
         "--require", "masksearch_queries_total",
         "--require", "masksearch_kernel_launches_total",
         "--require", "masksearch_jit_compiles_total"],
        input=text, capture_output=True, text=True, timeout=120)
    if check.returncode != 0:
        fail(f"/metrics: check_prometheus.py: {check.stdout}{check.stderr}")
    print(f"service /metrics: {len(text.splitlines())} lines pass "
          f"check_prometheus.py")
    stop_http(httpd, thread)
    service.close()
    close_window(ops, "float", ("cp_count_multi", "chi_cell_hist",
                                "mask_agg_counts"), t0)
    for qname, (sql, got) in grown.items():
        scan, _ = tq.run(sql, store, provided_rois=all_rois, use_index=False)
        if not payload_is(got, scan):
            fail(f"service {qname} after ingest: differs from the naive scan")
    print(f"service after ingest: scenario1_topk and scenario2_topk on "
          f"{len(store)} masks equal the naive scan")


def packed_service_sqls() -> list:
    """8 overlapping packed CP rankings: four ROIs, ones and zeros.  The
    four zero-count rankings (``(-0.5, 0.5)`` ASC) get a lower bound of 0
    on every mask: the zeros sit in CHI's open bottom bin ``[-inf, 1/16)``,
    which no range with a finite ``lv`` holds whole, and an ascending top-k
    stops only on lower bounds, so it verifies every mask (the descending
    rankings stop on their upper bounds, which count the end bins)."""
    out = []
    for roi in ("roi", "full_img", "(3, 5, 221, 223)", "(0, 32, 224, 64)"):
        for rng, order in (("(0.5, 1.5)", "DESC"), ("(-0.5, 0.5)", "ASC")):
            out.append("SELECT mask_id FROM MasksDatabaseView ORDER BY "
                       f"CP(mask, {roi}, {rng}) {order} LIMIT 25;")
    return out


def service_packed_phase(tq, ops, store, provided, sqls, results, naive):
    """The packed store behind the service, on the device backend: the
    packed filter, top-k and SCENARIO3_IOU one-shot, a /workload of 8
    overlapping packed CP rankings with the fused passes' descriptors per
    pass; one launch window."""
    from repro_torch.service import MaskSearchService, ServiceClient
    workload_wants = workload_answers(tq, store, packed_service_sqls(),
                                      provided)
    t0 = time.perf_counter()
    ops.reset_launches()
    service = MaskSearchService(store, provided_rois=provided,
                                backend="device", trace=True)
    httpd, thread, base = serve_http(service)
    client = ServiceClient(base, timeout=600)
    for qname, sql in sqls:
        if qname == "packed_refine":
            continue
        got, secs = timed(client.query, sql)
        if not (payload_is(got, results[(qname, "device")][0]) and
                payload_is(got, naive[qname][0])):
            fail(f"packed service {qname}: differs from the engine's and "
                 f"the naive scan's answers")
        print(f"packed service query {qname}: {secs:.3f} s, "
              f"{len(got['ids'])} ids equal to phase 6 and the naive scan")
    check_workload(client, packed_service_sqls(), workload_wants,
                   "packed service")
    passes = fused_passes(service)
    print(f"packed service workload: {len(passes)} fused passes, descriptors "
          f"per pass {q_histogram(passes)}; union masks per pass "
          f"{[m for _, m in passes]}")
    stop_http(httpd, thread)
    service.close()
    close_window(ops, "packed", ("cp_count_multi_packed",
                                 "mask_agg_counts_packed",
                                 "fused_bounds_verify"), t0)


def service_pair_phase(tq, ops, legs, provided, sqls):
    """Each pair leg behind the service, on the device backend: a /workload
    of the four pair queries, each equal to phase 8's answer; one launch
    window over both legs."""
    from repro_torch.service import MaskSearchService, ServiceClient
    t0 = time.perf_counter()
    ops.reset_launches()
    for leg, (store, _, _, results, _) in legs.items():
        service = MaskSearchService(store, provided_rois=provided,
                                    backend="device", trace=True)
        httpd, thread, base = serve_http(service)
        out, secs = timed(ServiceClient(base, timeout=600).workload,
                          [sql for _, sql in sqls])
        for (qname, _), payload in zip(sqls, out):
            if not payload_is(payload, results[(qname, "device")][0]):
                fail(f"pair {leg} service {qname}: differs from phase 8")
        passes = fused_passes(service, "scheduler.pair_pass")
        print(f"pair {leg} service workload: 4 pair queries in {secs:.3f} s, "
              f"each equal to phase 8; {len(passes)} pair passes, "
              f"descriptors per pass {q_histogram(passes)}")
        stop_http(httpd, thread)
        service.close()
    close_window(ops, "pair", PAIR_KERNELS, t0)


# -- the mesh backend on the card --------------------------------------------

MESH_KERNELS = {"float": ("cp_count", "cp_count_multi", "mask_agg_counts"),
                "packed": ("fused_bounds_verify", "cp_count_multi_packed",
                           "mask_agg_counts_packed"),
                "pair": PAIR_KERNELS}


def mesh_phase(torch, tq, ops, label, stores, provided, sqls, workload,
               smi, fused=None) -> None:
    """Each store's indexed queries on two meshes: every visible GPU (the
    named ``"mesh"`` backend, which the service uses) and four logical
    shards of ``cuda:0``; answers and ``ExecStats`` must equal the device
    backend's and ids and scores the naive scan's.  ``fused`` (positions,
    specs) adds one ``fused_counts`` pass on each mesh, equal to the device
    backend's.  Then one /workload per store through
    ``MaskSearchService(store, backend="mesh")``.  One launch window: every
    kernel the code routes these queries to must launch.  Each mesh keeps
    its largest per-shard call of every such kernel, held after the window
    against the kernel's plain version (tolerance 0).  ``stores`` maps a
    leg to (store, results, naive, workload answers); the references were
    all computed before the window opens."""
    from repro_torch.core import MeshBackend, get_backend
    from repro_torch.core.distributed import make_mesh
    from repro_torch.service import MaskSearchService, ServiceClient
    names = MESH_KERNELS[label]
    meshes = {"every GPU": lambda store: get_backend(store, "mesh"),
              "4 shards of cuda:0": lambda store: MeshBackend(
                  store, make_mesh((4,), ("data",), ["cuda:0"] * 4))}
    largest = {m: {} for m in meshes}
    fused_want = {leg: get_backend(v[0], "device").fused_counts(
        v[0], *fused) for leg, v in stores.items()} if fused else {}
    t0 = time.perf_counter()
    ops.reset_launches()
    for leg, (store, results, naive, wants) in stores.items():
        prefix = f"{label} {leg}".strip() if leg else label
        for mname, make in meshes.items():
            mesh_be = make(store)
            undo = record_largest(ops, names, largest[mname])
            mesh = mesh_be.mesh
            shards = (f"{mesh.size} shard(s) on "
                      f"{', '.join(sorted(set(map(str, mesh.devices))))}")
            for qname, sql in sqls:
                placed = mesh.placed_bytes
                t1 = time.perf_counter()
                res, stats = tq.run(sql, store, provided_rois=provided,
                                    backend=mesh_be)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                up = mesh.placed_bytes - placed
                rd, sd, _, dwall = results[(qname, "device")]
                hwall = results[(qname, "host")][3]
                if not (same_answer(res, rd) and
                        same_answer(res, naive[qname][0])):
                    fail(f"{prefix} mesh {qname} ({shards}): differs from "
                         f"the device backend's or the naive scan's answer")
                for f in STAT_FIELDS + ("bytes_loaded", "chi_bytes"):
                    if getattr(stats, f) != getattr(sd, f):
                        fail(f"{prefix} mesh {qname} ({shards}): {f} "
                             f"{getattr(stats, f)}, device "
                             f"{getattr(sd, f)}")
                print(f"{prefix} mesh query {qname} ({shards}): mesh "
                      f"{wall:.3f} s, device {dwall:.3f} s, host "
                      f"{hwall:.3f} s; uploaded {up} B; "
                      + json.dumps({f: getattr(stats, f)
                                    for f in STAT_FIELDS})
                      + f" ({smi})")
            if fused:
                got = mesh_be.fused_counts(store, *fused)
                if not np.array_equal(got, fused_want[leg]):
                    fail(f"{prefix} mesh fused_counts ({shards}): differs "
                         f"from the device backend's")
                print(f"{prefix} mesh fused_counts ({shards}): "
                      f"{len(fused[1])} descriptors x {len(fused[0])} "
                      f"masks equal to the device backend's")
            undo()
        service = MaskSearchService(store, provided_rois=provided,
                                    backend="mesh", trace=True)
        served = service.stats()["backend"]
        if served != "mesh":
            fail(f"{prefix} mesh service: backend {served}")
        undo = record_largest(ops, names, largest["every GPU"])
        httpd, thread, base = serve_http(service)
        check_workload(ServiceClient(base, timeout=600), workload, wants,
                       f"{prefix} mesh service")
        stop_http(httpd, thread)
        service.close()
        undo()
    print(f"mesh {label}: cp_count_packed launches "
          f"{ops.launch_counts()['cp_count_packed']}")
    close_window(ops, label, MESH_KERNELS[label], t0, kind="mesh")
    for mname, calls in largest.items():
        for name in names:
            if name not in calls:
                fail(f"{label} mesh on {mname}: {name} was never called")
            mesh_parity(torch, ops, name, calls[name][1],
                        f"{label} mesh on {mname}", smi)


def mesh_parity(torch, ops, name, a, where, smi, kind="mesh") -> None:
    """Hold a kernel's largest per-shard mesh call (or, with ``kind``, a
    window's largest call) ``a`` against its plain version on the same
    inputs (tolerance 0) and time both, on the shard's device."""
    k = getattr(ops, name)
    with torch.cuda.device(a[0].device):
        err = max_abs_err(torch, k(*a), k.plain(*a))
        if err != 0:
            fail(f"{name} differs from its plain version at the {where} "
                 f"call {tuple(a[0].shape)} (max abs err {err})")
        ms = time_ms(torch, lambda: k(*a), reps=5, warmup=1)
        plain_ms = time_ms(torch, lambda: k.plain(*a), reps=3, warmup=1)
    print(f"{kind} parity {name} ({where}): largest "
          f"{'per-shard ' if kind == 'mesh' else ''}call "
          f"{tuple(a[0].shape)} {str(a[0].dtype).replace('torch.', '')} on "
          f"{a[0].device} equal (max abs err 0); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms ({smi})")


def config_params(cfg) -> int:
    """A dense GQA decoder's parameter count from its config alone (tied
    embedding over the padded vocab; 2,533,787,648 for granite-3.0-2B)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (2 * d + 2 * d * cfg.num_heads * hd +
                 2 * d * cfg.num_kv_heads * hd + 3 * d * cfg.d_ff)
    return cfg.padded_vocab * d + d + cfg.num_layers * per_layer


def producer_sql(lv: float, fv: float, cut: float) -> list:
    """Scenario 1's ranking over the span's key columns (LIMIT 256) from
    the lower value ``lv``, and a CP filter over the same ROI from ``fv``
    whose ``cut`` splits the masks (``query_cuts``)."""
    return [("scenario1_topk",
             "SELECT mask_id FROM MasksDatabaseView ORDER BY "
             f"CP(mask, roi, ({lv!r}, 1.0)) / AREA(roi) ASC "
             f"LIMIT {PRODUCER_LIMIT};"),
            ("attended_filter",
             "SELECT mask_id FROM MasksDatabaseView WHERE "
             f"CP(mask, roi, ({fv!r}, 1.0)) / AREA(roi) > {cut!r};")]


def roi_counts(span, lv) -> np.ndarray:
    """Each mask's count of ROI pixels with ``lv <= m < 1``, on the host."""
    return ((span >= lv) & (span < 1.0)).sum(axis=(1, 2))


def query_cuts(masks) -> tuple:
    """``producer_sql``'s thresholds, from the masks' own values over the
    ROI, so that each query splits them whatever their range (whisper's
    top out at 0.13): ``lv`` is the median ROI value in (0, 1), lowered
    if need be until at most half the LIMIT of the masks have no pixel
    from it; ``fv`` the values' first quartile; ``cut`` halfway between
    the two adjacent attended shares at ``fv`` that part the masks
    nearest their middle, so that no mask's share lies near it.  The
    values are float32's, so that the kernels and the host compare alike."""
    r0, c0, r1, c1 = PRODUCER_ROI
    span = masks[:, r0:r1, c0:c1]
    sample = span[:, ::7, ::7]
    inner = sample[(sample > 0) & (sample < 1.0)]
    top = np.where(span < 1.0, span, 0).max(axis=(1, 2))
    lv = min(np.median(inner),
             np.quantile(top, PRODUCER_LIMIT / (2 * len(masks))))
    lv = float(np.float32(lv))
    fv = float(np.float32(np.quantile(inner, 0.25)))
    at_fv = np.sort(roi_counts(span, fv))
    counts = np.unique(at_fv)
    if len(counts) < 2:
        fail(f"every mask has {counts} ROI pixels from {fv}: no cut splits "
             f"them")
    above = len(masks) - np.searchsorted(at_fv, counts[:-1], side="right")
    j = int(np.argmin(np.abs(above - len(masks) / 2)))
    cut = float((counts[j] + counts[j + 1]) / 2 / span[0].size)
    return lv, fv, cut


def check_split(results, masks, lv, fv, cut, kind) -> None:
    """Each query splits the masks, by the host's own counts: the ranking
    returns the ``PRODUCER_LIMIT`` masks of fewest ROI pixels from
    ``lv``, with the host's scores, at least one of them non-zero (a
    kernel that counted nothing would rank every mask 0); the filter
    returns some but not all masks, those whose share from ``fv`` is over
    ``cut``."""
    r0, c0, r1, c1 = PRODUCER_ROI
    span = masks[:, r0:r1, c0:c1]
    n, area = len(masks), span[0].size
    ids, scores = results[("scenario1_topk", "device")][0]
    ids = np.asarray(ids)
    counts = roi_counts(span, lv)
    rest = np.setdiff1d(np.arange(n), ids)
    if (len(ids) != PRODUCER_LIMIT or counts[ids].max() == 0 or
            counts[ids].max() > counts[rest].min() or
            not np.allclose(np.asarray(scores, np.float64),
                            counts[ids] / area, rtol=1e-6, atol=0)):
        fail(f"{kind} scenario1_topk does not split the masks: host counts "
             f"{counts[ids].min()}..{counts[ids].max()} returned, "
             f"{counts[rest].min()}.. left out")
    got = np.sort(np.asarray(results[("attended_filter", "device")][0]))
    want = np.flatnonzero(roi_counts(span, fv) > cut * area)
    if not 0 < len(got) < n or not np.array_equal(got, want):
        fail(f"{kind} attended_filter: {len(got)} of {n} masks, the host "
             f"counts {len(want)}")
    print(f"{kind} split check: the ranking from {lv!r} returns the "
          f"{PRODUCER_LIMIT} masks of fewest ROI pixels ({counts[ids].min()}"
          f"..{counts[ids].max()} of {area}; left out from "
          f"{counts[rest].min()}); the filter from {fv!r} over {cut!r} "
          f"returns {len(got)} of {n}; both as the host counts")


def index_and_query(torch, dev, masks, n_first, kind, smi):
    """Phase 10's index-and-query window over ``masks`` (host float32,
    (n, 224, 224)): ``create_memory`` of the first ``n_first`` on the card,
    ``append`` of the rest, then ``producer_sql``'s two queries (at
    ``query_cuts``' thresholds) on the device and host backends and as
    naive scans, all in a launch window of its own (``{kind}
    launches``); device == host == naive scan == the host's own counts
    (``check_split``); the window's largest
    ``chi_cell_hist``, ``cp_count_multi`` and ``cp_count`` calls held
    against their plain versions (``{kind} parity``).  Returns the store,
    the results and the provided ROIs."""
    from repro_torch.core import CHIConfig, MaskStore
    from repro_torch.core import queries as tq
    from repro_torch.core.store import MASK_META_DTYPE
    from repro_torch.kernels import ops

    n = len(masks)
    meta = make_meta(n, MASK_META_DTYPE)
    meta["image_id"] = np.arange(n)
    meta["mask_type"] = 1
    chi_cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)
    provided = np.tile(np.asarray(PRODUCER_ROI, np.int32), (n, 1))
    cuts = query_cuts(masks)
    sqls = producer_sql(*cuts)
    largest: dict = {}
    undo = record_largest(ops, PRODUCER_KERNELS, largest)
    t0 = time.perf_counter()
    ops.reset_launches()
    store, _, _ = ingest(torch, MaskStore, chi_cfg, dev, meta,
                         (masks[:n_first], masks[n_first:]), ops,
                         packed=False, label=f"{kind} ingest")
    results = run_queries(torch, tq, ops, store, sqls, provided, f"{kind} ")
    naive = naive_scans(torch, tq, ops, store, sqls, provided)
    undo()
    close_window(ops, "index+query", PRODUCER_KERNELS, t0, kind=kind)
    check_answers(results, naive, sqls, f"{kind} ")
    check_split(results, masks, *cuts, kind)
    for name in PRODUCER_KERNELS:
        if name not in largest:
            fail(f"{kind}: {name} was never called")
        mesh_parity(torch, ops, name, largest[name][1], f"{kind} window",
                    smi, kind=kind)
    return store, results, provided


def stack_loss(m, b, emb):
    """Input saliency's loss: a decoder's blocks run from the injected
    embeddings ``emb``, each recomputed in the backward pass, then the
    tied head's cross-entropy against ``b["labels"]``."""
    import torch
    from repro_torch.models.layers import (cross_entropy, logits_from_tied,
                                           rms_norm)
    from torch.utils.checkpoint import checkpoint
    pos = torch.arange(emb.shape[1], device=emb.device).expand(emb.shape[:2])
    x = emb
    for blk in m.blocks:
        x = checkpoint(blk, x, pos, use_reentrant=False)
    h = rms_norm(x, m.final_norm, m.cfg.norm_eps)
    labels = torch.as_tensor(b["labels"], device=emb.device)
    return cross_entropy(logits_from_tied(m.embedding, h, m.cfg.vocab_size),
                         labels)


def producer_cut_checks(torch, cfg, dev, smi) -> None:
    """A two-layer float32 cut of the model at full width, its ``wq`` and
    ``wk`` at an eighth of the init scale (attention scores of order one;
    at the init's own scale the softmax is near an argmax and the last bit
    of a GEMM decides it, as the CPU tests note): decode against
    teacher forcing (tolerance 2e-2, as the reference's test), then the
    card's logits and attention maps against the port's CPU path with the
    same weights (atol 1e-3 and 1e-5, TF32 off)."""
    import dataclasses
    from repro_torch.models import build_model
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    card = build_model(cut, dev).init(torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        for blk in card.blocks:
            blk.mixer.wq.mul_(0.125)
            blk.mixer.wk.mul_(0.125)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        full, _ = card.logits({"tokens": tokens})
    cache = card.init_cache(2, 32)
    lp, cache = card.prefill({"tokens": tokens[:, :16]}, cache)
    steps = [(lp[:, 0], full[:, 15])]
    for pos in range(16, 24):
        ld, cache = card.decode_step(cache, tokens[:, pos:pos + 1], pos)
        steps.append((ld[:, 0], full[:, pos]))
    err = max(float((got - want).abs().max()) for got, want in steps)
    if not all(bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())
               for got, want in steps):
        fail(f"producer: decode leaves teacher forcing (max err {err})")
    cpu = build_model(cut, "cpu")
    cpu.load_state_dict(card.state_dict())
    batch = {"tokens": tokens}
    with torch.no_grad():
        e_logits = float((card.logits(batch)[0].cpu() -
                          cpu.logits(batch)[0]).abs().max())
    e_maps = float((card.attention_maps(batch).cpu() -
                    cpu.attention_maps(batch)).abs().max())
    if e_logits > 1e-3 or e_maps > 1e-5:
        fail(f"producer: the card's float32 cut differs from the CPU "
             f"(logits {e_logits}, attention maps {e_maps})")
    print(f"producer check: 2-layer float32 cut at full width: prefill + 8 "
          f"decode steps equal teacher forcing (max err {err:.3e}, "
          f"rtol = atol = 2e-2); card vs CPU max err logits {e_logits:.3e} "
          f"(atol 1e-3), attention maps {e_maps:.3e} (atol 1e-5), TF32 off "
          f"({smi})")


def producer_phase(torch, dev, smi) -> None:
    """Phase 10: the mask producers.  granite-3.0-2B at full width (random
    weights from generator seed 0) serves prefill and greedy decode,
    harvests 4,096 224x224 last-layer attention masks from
    ``SyntheticLMData`` through ``PrefetchIterator`` and one batch of input
    saliency; the masks are ingested into a card store (the CHI kernel's
    path) and queried on the device and host backends and as naive scans
    in a launch window of their own; then the top-k's masks and token rows
    are augmented."""
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.core import CHIConfig, augment, build_chi_np, saliency
    from repro_torch.data.pipeline import (AugmentedData, PrefetchIterator,
                                           SyntheticLMData)
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import count_params

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = load_arch(PRODUCER_ARCH)

    # -- 10a. build the model at full width -----------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(model)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if n_params != config_params(cfg):
        fail(f"producer: {n_params:,} parameters, the config gives "
             f"{config_params(cfg):,}")
    print(f"producer model: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), {cfg.dtype}: {n_params:,} parameters, "
          f"{n_bytes:,} B; random init {time.perf_counter() - t0:.1f} s "
          f"({smi})")

    # -- 10b. serve: prefill, then greedy decode with the KV cache -----------
    prompt = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    serve.greedy_generate(model, prompt, 2)              # warm-up
    out = serve.greedy_generate(model, prompt, SERVE_STEPS + 1)
    if not out["finite"]:
        fail("producer serve: non-finite logits")
    step_ms = out["decode_s"] / SERVE_STEPS * 1e3
    print(f"producer serve: prefill {SERVE_BATCH}x{SERVE_PROMPT} "
          f"{out['prefill_s'] * 1e3:.3f} ms; {SERVE_STEPS} greedy decode "
          f"steps x{SERVE_BATCH}: {step_ms:.3f} ms a step, "
          f"{SERVE_STEPS * SERVE_BATCH / out['decode_s']:.1f} tok/s "
          f"(bound {n_bytes / PEAK_BYTES_S * 1e3:.3f} ms a step: the "
          f"weights read once); logits finite; sample "
          f"{out['tokens'][0, :8].tolist()} ({smi})")
    producer_cut_checks(torch, cfg, dev, smi)

    # -- 10c. harvest: last-layer attention masks, then input saliency -------
    data = SyntheticLMData(cfg, H, N_PRODUCED, seed=0).batch_at(0)
    source = ({"tokens": data["tokens"][i:i + PRODUCER_BATCH]}
              for i in range(0, N_PRODUCED, PRODUCER_BATCH))
    model.attention_maps({"tokens": data["tokens"][:2]})   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    produced = [saliency.last_layer_attention(model.attention_maps(b))
                for b in PrefetchIterator(source, depth=2)]
    masks_dev = torch.cat(produced)
    torch.cuda.synchronize()
    harvest_s = time.perf_counter() - t0
    del produced
    masks = masks_dev.cpu().numpy()
    if masks.shape != (N_PRODUCED, H, W) or masks.dtype != np.float32:
        fail(f"producer: masks {masks.shape} {masks.dtype}")
    if not (np.isfinite(masks).all() and masks.min() >= 0 and
            masks.max() < 1):
        fail("producer: masks are not finite values in [0, 1)")
    n_tok = N_PRODUCED * H
    # per token: Q/K/V/O, the SwiGLU FFN and the scores and P·V of 39
    # blocks, plus the last block's Q/K and scores (no LM head)
    per_tok = (cfg.num_layers - 1) * 2 * (
        2 * cfg.d_model * cfg.num_heads * cfg.head_dim +
        2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim +
        3 * cfg.d_model * cfg.d_ff) + 2 * cfg.d_model * (
        cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim
    attn_ops = (2 * cfg.num_layers - 1) * 2 * cfg.num_heads * \
        cfg.head_dim * H * H * N_PRODUCED // 2
    flops = per_tok * n_tok + attn_ops
    print(f"producer harvest: {N_PRODUCED} masks {H}x{W} float32 "
          f"({masks.nbytes:,} B) from {n_tok:,} tokens in {harvest_s:.3f} s: "
          f"{n_tok / harvest_s:,.0f} tok/s, {N_PRODUCED / harvest_s:.1f} "
          f"masks/s; {flops:.4e} FLOP, bound {flops / PEAK_BF16_OPS_S:.3f} s "
          f"at the bf16 peak ({smi})")
    del masks_dev

    model.requires_grad_(False)
    batch = {"tokens": data["tokens"][:PRODUCER_BATCH],
             "labels": data["labels"][:PRODUCER_BATCH]}
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = saliency.input_saliency(stack_loss, model, {
        **batch, "embeddings": model.embedding[tokens] * torch.tensor(
            cfg.embed_scale, dtype=model.dtype)})
    grid = saliency.resize_mask(saliency.tokens_to_grid(
        scores.float(), 16, 14), H, W)
    torch.cuda.synchronize()
    sal_s = time.perf_counter() - t0
    g = grid.cpu().numpy()
    # bf16 scores: normalize01's 1 - 1e-6 rounds to 1.0 (the reference's
    # fault too), so the top score is 1.0, not below it
    if g.shape != (PRODUCER_BATCH, H, W) or not np.isfinite(g).all() or \
            g.min() < 0 or g.max() > 1 or not (g > 0).any():
        fail("producer input saliency: not finite masks in [0, 1]")
    print(f"producer input saliency: {PRODUCER_BATCH} x {H} tokens through "
          f"all {cfg.num_layers} blocks and back in {sal_s:.3f} s, "
          f"tokens_to_grid 16x14 -> resize_mask {H}x{W}, values in "
          f"[{g.min()}, {g.max()}] (bf16 scores; top score "
          f"{float(scores.max())}); peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})")
    del model, scores, grid
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10d-e. index, then query: one launch window -------------------------
    store, results, provided = index_and_query(torch, dev, masks,
                                               N_PRODUCED_FIRST, "producer",
                                               smi)
    sample = slice(0, 64)
    chi_cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)
    want = build_chi_np(masks[N_PRODUCED_FIRST:][sample], chi_cfg)
    if not np.array_equal(store.chi_chunks[1][sample], want):
        fail("producer: the appended CHI chunk differs from build_chi_np")
    print("producer ingest check: the appended CHI chunk equals "
          "build_chi_np on a 64-mask sample")

    # -- 10f. augment the top-k's masks and token rows -----------------------
    r0, c0, r1, c1 = PRODUCER_ROI
    ids = np.asarray(results[("scenario1_topk", "device")][0][0])
    imgs = torch.as_tensor(masks[ids], device=dev)
    out = augment.randomize_outside_roi(torch.Generator(dev).manual_seed(0),
                                        imgs, provided[ids])
    inside = torch.zeros((H, W), dtype=torch.bool, device=dev)
    inside[r0:r1, c0:c1] = True
    changed = float((out != imgs)[:, ~inside].float().mean())
    if not torch.equal(out[:, inside], imgs[:, inside]) or changed < 0.999:
        fail(f"producer augment: inside the ROI changed or outside kept "
             f"({changed} of the outside pixels changed)")
    toks = torch.as_tensor(data["tokens"], device=dev)
    selected = torch.zeros(N_PRODUCED, dtype=torch.bool, device=dev)
    selected[torch.as_tensor(ids, device=dev)] = True
    mixed = augment.mix_augmented(torch.Generator(dev).manual_seed(1), toks,
                                  selected, cfg.vocab_size)
    redrawn = float((mixed[selected] != toks[selected]).float().mean())
    if not torch.equal(mixed[~selected], toks[~selected]) or redrawn < 0.9 \
            or int(mixed.max()) >= cfg.vocab_size:
        fail("producer mix_augmented: rows other than the selected changed")
    aug = AugmentedData(SyntheticLMData(cfg, H, PRODUCER_BATCH, seed=1))
    rows = mixed[selected].cpu().numpy()
    aug.add_augmented({"tokens": rows, "labels": rows})
    mixed_batch = aug.batch_at(0)
    base = aug.base.batch_at(0)
    half = PRODUCER_BATCH // 2
    if not (np.array_equal(mixed_batch["tokens"][:half], rows[:half]) and
            np.array_equal(mixed_batch["tokens"][half:],
                           base["tokens"][half:])):
        fail("producer AugmentedData: the batch does not mix the rows in")
    print(f"producer augment: {len(ids)} top-k masks: inside the ROI "
          f"bit-identical, {changed:.6f} of the outside pixels replaced; "
          f"mix_augmented redrew {redrawn:.4f} of the {len(ids)} selected "
          f"rows' tokens and none of the others; AugmentedData mixes "
          f"{half} of them into a {PRODUCER_BATCH}-row batch")
    print(f"producer phase: {time.perf_counter() - t_phase:.1f} s")


# -- 11. training on the card ---------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 4, 2, 3
LOOP_MASKS, LOOP_FIRST, LOOP_RETRAIN = 1024, 512, 2


def rel_err(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mean_in_roi(masks) -> float:
    """The masks' mean share of their mass inside ``PRODUCER_ROI``."""
    r0, c0, r1, c1 = PRODUCER_ROI
    return float((masks[:, r0:r1, c0:c1].sum((1, 2)) /
                  masks.sum((1, 2))).mean())


def harvest(torch, saliency, model, data, n_batches) -> np.ndarray:
    """Last-layer attention masks of ``data``'s first batches (host
    float32)."""
    out = [saliency.last_layer_attention(model.attention_maps(
        data.batch_at(i))) for i in range(n_batches)]
    return torch.cat(out).cpu().numpy()


def params_within_rule(torch, got, want, noisy, lr_sum) -> float:
    """``tests/test_torch_train.py``'s rule for params after train steps in
    float32: within 1e-5 of scale (the reference leaf's largest magnitude,
    at least 1) plus 1e-5 relative, and up to 2.5 · Σ lr more where a grad
    element was under the rounding noise.  Fails otherwise; returns the
    largest error outside and inside the allowance's elements."""
    worst = [0.0, 0.0]
    for (name, p), q, n in zip(got, want, noisy):
        a, b = p.detach().cpu().double(), q.detach().cpu().double()
        err = (a - b).abs()
        base = 1e-5 * max(1.0, float(b.abs().max())) + 1e-5 * b.abs()
        if not bool((err <= base + 2.5 * lr_sum * n).all()):
            fail(f"train check: {name} leaves the float32 rule (max err "
                 f"{float(err.max())})")
        for i, part in enumerate((err[~n], err[n])):
            if part.numel():
                worst[i] = max(worst[i], float(part.max()))
    return worst


def train_cut_checks(torch, cfg, dev, smi) -> None:
    """11c: a two-layer float32 cut of granite at full width (``wq``/``wk``
    at an eighth of the init scale, as the producer's cut): one train step
    on the card against the same step on the CPU; ``rms_norm``'s
    hand-written VJP against autograd of the plain forward; and a resume
    from a checkpoint against the uninterrupted run."""
    import dataclasses
    import tempfile
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.models.layers import rms_norm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (make_loss_and_grads,
                                              make_train_step)
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    opt_cfg = OptConfig(warmup_steps=2, total_steps=20)
    data = SyntheticLMData(cut, 64, 4, seed=3)

    def built(seed):
        m = build_model(cut, dev).init(torch.Generator(dev).manual_seed(seed))
        with torch.no_grad():
            for blk in m.blocks:
                blk.mixer.wq.mul_(0.125)
                blk.mixer.wk.mul_(0.125)
        return m

    card = built(1)
    cpu = build_model(cut, "cpu")
    cpu.load_state_dict(card.state_dict())
    batch = data.batch_at(0)
    _, _, grads = make_loss_and_grads(cpu)(batch)
    noisy = [g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))
             for g in grads]
    met = {}
    for name, m in (("card", card), ("cpu", cpu)):
        opt = init_opt_state(m.parameters(), opt_cfg)
        _, met[name] = make_train_step(m, opt_cfg, microbatches=2)(opt, batch)
    e_loss = rel_err(float(met["card"]["loss"]), float(met["cpu"]["loss"]))
    e_gn = rel_err(float(met["card"]["grad_norm"]),
                   float(met["cpu"]["grad_norm"]))
    if e_loss > 1e-5 or e_gn > 1e-4:
        fail(f"train check: the card's step differs from the CPU's (loss "
             f"{e_loss}, grad norm {e_gn} relative)")
    worst, inside = params_within_rule(
        torch, list(card.named_parameters()), list(cpu.parameters()), noisy,
        float(met["cpu"]["lr"]))
    n_noisy = sum(int(n.sum()) for n in noisy)
    print(f"train check: 2-layer float32 cut at full width, one step of "
          f"2 x 2 x 64 tokens on the card vs the CPU: loss "
          f"{float(met['card']['loss']):.6f} (rel err {e_loss:.3e}, limit "
          f"1e-5), grad norm {float(met['card']['grad_norm']):.4f} (rel err "
          f"{e_gn:.3e}, limit 1e-4); params within 1e-5 of scale (max err "
          f"{worst:.3e}) outside {n_noisy:,} elements whose grads are under "
          f"the noise (allowed 2.5 lr = {2.5 * float(met['cpu']['lr']):.3e} "
          f"more; max err there {inside:.3e}); TF32 off ({smi})")
    del cpu, grads, noisy

    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((2, TRAIN_SEQ, cfg.d_model),
                                            dtype=np.float32), device=dev)
    w = torch.as_tensor(0.1 * rng.standard_normal(cfg.d_model,
                                                  dtype=np.float32),
                        device=dev)
    g = torch.as_tensor(rng.standard_normal(x.shape, dtype=np.float32),
                        device=dev)
    pair = []
    for fn in (rms_norm, lambda a, b, eps: a * torch.rsqrt(
            a.square().mean(-1, keepdim=True) + eps) * (1.0 + b)):
        a, b = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        fn(a, b, cfg.norm_eps).backward(g)
        pair.append((a.grad, b.grad))
    errs = []
    for got, want in zip(*pair):
        err = float((got - want).abs().max())
        errs.append(err)
        if err > 1e-5 * max(1.0, float(want.abs().max())):
            fail(f"train check: rms_norm's VJP differs from autograd of the "
                 f"plain forward (max abs err {err})")
    print(f"train check: rms_norm's hand-written VJP on "
          f"{tuple(x.shape)} float32 vs autograd of the plain forward: dx "
          f"max err {errs[0]:.3e}, dw {errs[1]:.3e} (limit 1e-5 of scale) "
          f"({smi})")
    del x, g, pair

    def steps(model, opt, step_fn, at):
        for s in at:
            opt, _ = step_fn(opt, data.batch_at(s))
        return opt

    first = built(1)
    step_fn = make_train_step(first, opt_cfg)
    opt = steps(first, init_opt_state(first.parameters(), opt_cfg), step_fn,
                (0,))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt.save(tmp, 1, {"params": first, "opt": opt})
        save_s = time.perf_counter() - t0
        steps(first, opt, step_fn, (1, 2))
        second = built(99)
        t0 = time.perf_counter()
        state, at = ckpt.restore_latest(tmp, {
            "params": second, "opt": init_opt_state(second.parameters(),
                                                    opt_cfg)})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if at != 1:
        fail(f"train check: restored step {at}, saved 1")
    steps(second, state["opt"], make_train_step(second, opt_cfg), (1, 2))
    err = 0.0
    for (name, p), q in zip(second.named_parameters(), first.parameters()):
        e = float((p.detach() - q.detach()).abs().max())
        if e > 1e-6 * max(1.0, float(q.detach().abs().max())):
            fail(f"train check: resumed {name} differs by {e}")
        err = max(err, e)
    print(f"train check: save at step 1 ({save_s:.1f} s), 2 more steps; "
          f"restore into a fresh model ({restore_s:.1f} s) and the same 2 "
          f"steps: params max err {err:.3e} (limit 1e-6 of scale; the "
          f"embedding's backward may add in any order on the card) ({smi})")


def training_phase(torch, dev, smi) -> None:
    """Phase 11: training.  ``launch/train.py`` trains granite-3.0-2B at
    full width (11a); Scenario 1's loop continues from its model and
    optimizer state: harvest, index and query, augment, retrain, harvest
    again (11b); checks at a two-layer float32 cut (11c); the Scenario 1
    example at its own size (11d)."""
    import gc
    import importlib.util
    from repro_torch.configs import load_arch
    from repro_torch.core import augment, saliency
    from repro_torch.data.pipeline import AugmentedData, SyntheticLMData
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = load_arch(PRODUCER_ARCH)
    n_params = config_params(cfg)

    # -- 11a. the trainer at full width ---------------------------------------
    # Random weights from generator seed 0, ``wq`` and ``wk`` at an eighth
    # of the init scale (scores of order one, as the producer's cut): at
    # the init's own scale the grads grow ~5x a layer and at 40 layers the
    # f32 global norm overflows, so the clip zeroes every update (the
    # reference's init and arithmetic; ROADMAP §3).
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    with torch.no_grad():
        for blk in model.blocks:
            blk.mixer.wq.mul_(0.125)
            blk.mixer.wk.mul_(0.125)
    print(f"train: {cfg.name} at full width, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens a step in {TRAIN_MICRO} microbatches, {TRAIN_STEPS} "
          f"steps; wq and wk at 1/8 of the init scale; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated before "
          f"the optimizer state ({smi})")
    run = train_cli.run(["--arch", PRODUCER_ARCH, "--device", str(dev),
                         "--steps", str(TRAIN_STEPS), "--seq-len",
                         str(TRAIN_SEQ), "--global-batch", str(TRAIN_BATCH),
                         "--microbatches", str(TRAIN_MICRO),
                         "--log-every", "1"], model=model)
    model, opt, opt_cfg = run["model"], run["opt_state"], run["opt_cfg"]
    if len(run["records"]) != TRAIN_STEPS:
        fail(f"train: {len(run['records'])} steps run")
    for rec in run["records"]:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["grad_norm"])):
            fail(f"train step {rec['step']}: loss {rec['loss']}, grad norm "
                 f"{rec['grad_norm']}")
        mfu = 6 * n_params * rec["tokens"] / rec["step_s"] / PEAK_BF16_OPS_S
        print(f"train step {rec['step']}: loss {rec['loss']:.4f}, grad norm "
              f"{rec['grad_norm']:.4f}, lr {rec['lr']:.4e}, step "
              f"{rec['step_s'] * 1e3:.3f} ms, "
              f"{rec['tokens'] / rec['step_s']:,.1f} tok/s, MFU {mfu:.4f} "
              f"(6 N T / step / 989 TFLOP/s), optimizer "
              f"{rec['opt_s'] * 1e3:.3f} ms, peak "
              f"{rec['peak_bytes'] / 1e9:.2f} GB ({smi})")

    # -- 11b. Scenario 1's loop at full width -------------------------------
    probe = SyntheticLMData(cfg, H, PRODUCER_BATCH)
    n_batches = LOOP_MASKS // PRODUCER_BATCH
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = harvest(torch, saliency, model, probe, n_batches)
    harvest_s = time.perf_counter() - t0
    if masks.shape != (LOOP_MASKS, H, W) or not (
            np.isfinite(masks).all() and masks.min() >= 0 and
            masks.max() < 1):
        fail("loop: harvested masks are not finite values in [0, 1)")
    before = mean_in_roi(masks)
    print(f"loop harvest: {LOOP_MASKS} masks {H}x{W} from the trained model "
          f"in {harvest_s:.3f} s ({LOOP_MASKS / harvest_s:.1f} masks/s)")

    store, results, _ = index_and_query(torch, dev, masks, LOOP_FIRST,
                                        "loop", smi)

    ids = np.asarray(results[("scenario1_topk", "device")][0][0])
    rows = store.positions_of(ids)
    tokens = np.concatenate([probe.batch_at(i)["tokens"]
                             for i in range(n_batches)])
    labels = np.concatenate([probe.batch_at(i)["labels"]
                             for i in range(n_batches)])
    selected = torch.zeros(LOOP_MASKS, dtype=torch.bool, device=dev)
    selected[torch.as_tensor(rows, device=dev)] = True
    mixed = augment.mix_augmented(torch.Generator(dev).manual_seed(2),
                                  torch.as_tensor(tokens, device=dev),
                                  selected, cfg.vocab_size).cpu().numpy()
    if not np.array_equal(mixed[~selected.cpu().numpy()],
                          tokens[~selected.cpu().numpy()]):
        fail("loop mix_augmented: rows other than the flagged changed")
    aug = AugmentedData(SyntheticLMData(cfg, H, PRODUCER_BATCH, seed=1))
    half = PRODUCER_BATCH // 2
    for i in range(0, len(rows), half):
        part = rows[i:i + half]
        aug.add_augmented({"tokens": mixed[part], "labels": labels[part]})
    step_fn = make_train_step(model, opt_cfg)
    retrain = []
    for s in range(LOOP_RETRAIN):
        batch = aug.batch_at(s)
        if not np.array_equal(batch["tokens"][:half],
                              mixed[rows[s * half:(s + 1) * half]]):
            fail("loop AugmentedData: the flagged rows are not mixed in")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, met = step_fn(opt, batch)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        retrain.append((loss, gn, time.perf_counter() - t0))
        if not (np.isfinite(loss) and np.isfinite(gn)):
            fail(f"loop retrain step {s}: loss {loss}, grad norm {gn}")
    masks2 = harvest(torch, saliency, model, probe, n_batches)
    print(f"loop augment + retrain: {len(rows)} flagged rows redrawn with "
          f"mix_augmented and mixed {half} to a batch through "
          f"AugmentedData; {LOOP_RETRAIN} steps of {PRODUCER_BATCH} x {H}: "
          + "; ".join(f"loss {lo:.4f}, grad norm {g:.4f}, {t * 1e3:.3f} ms"
                      for lo, g, t in retrain)
          + f"; mean in-ROI attention of the probe {before:.6f} before, "
          f"{mean_in_roi(masks2):.6f} after (not asserted: random weights, "
          f"{LOOP_RETRAIN} steps) ({smi})")
    del model, opt, run, step_fn, store, masks, masks2
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11c. checks at the two-layer float32 cut -----------------------------
    train_cut_checks(torch, cfg, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11d. the Scenario 1 example at its own size --------------------------
    path = os.path.join(ROOT, "examples", "scenario1_debugging_torch.py")
    spec = importlib.util.spec_from_file_location("scenario1_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        example.main(["--device", str(dev)])
    lines = out.getvalue().splitlines()
    for line in lines:
        print(f"scenario1 example: {line}")
    if len(lines) < 4 or not lines[1].startswith("query flagged"):
        fail("scenario1 example: its lines are missing")
    print(f"scenario1 example: {time.perf_counter() - t0:.1f} s on {dev}")
    print(f"training phase: {time.perf_counter() - t_phase:.1f} s")


# -- 12. the other producers: recurrent and encoder-decoder families ---------

def decode_bytes(model, cache, pos: int) -> int:
    """The bytes a greedy decode step at position ``pos`` must move: the
    parameters it reads (a decoder LM's all; an encoder-decoder's decoder,
    embedding and final norm, not its encoder), every cache tensor read
    once — of a self-attention ``k``/``v`` (MLA: ``ckv``/``kpe``) only the
    ``pos + 1`` slots the step attends to (the port's masked read touches
    the empty ones as well) —, and the recurrent states (``h``,
    ``state``) written once more."""
    if model.cfg.is_encoder_decoder:
        params = [p for n, p in model.named_parameters()
                  if not n.startswith(("enc.", "enc_norm"))]
    else:
        params = list(model.parameters())
    n = sum(p.numel() * p.element_size() for p in params)
    for c in cache:
        for k, t in c.items():
            size = t.numel() * t.element_size()
            if k in ("k", "v", "ckv", "kpe"):
                size = size // t.shape[1] * min(pos + 1, t.shape[1])
            n += size * (2 if k in ("h", "state") else 1)
    return n


def other_prompt(serve, cfg):
    """Phase 12's serve prompt: 8 x 128 tokens, or for whisper 8 x 1,500
    frames and a 16-token prompt."""
    if cfg.is_encoder_decoder:
        return serve.prompt_batch(cfg, SERVE_BATCH, WHISPER_PROMPT,
                                  enc_len=WHISPER_FRAMES)
    return serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT)


def other_cut_checks(torch, cfg, dev, smi) -> None:
    """``producer_cut_checks``' pattern for the other families: a float32
    cut at full width (recurrentgemma 3 layers, one whole group, so that
    it holds its local attention layer; mamba2 2 layers; whisper 2 + 2),
    random weights from generator seed 1 with ``wq``/``wk`` at 1/8 of the
    init scale: prefill + 8 decode steps against teacher forcing (2e-2,
    as the reference's test), then the card against the CPU with the same
    weights, TF32 off: logits (1e-4 of their scale) and the family's mask
    source (attention maps and cross maps 1e-5, input saliency 1e-4)."""
    import dataclasses
    from repro_torch.core import saliency
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import logits_from_tied
    if cfg.is_encoder_decoder:
        cut = dataclasses.replace(cfg, num_layers=2, enc_layers=2,
                                  dec_layers=2, dtype="float32")
    else:
        cut = dataclasses.replace(cfg, num_layers=3 if "rglru" in
                                  cfg.layer_pattern else 2, dtype="float32")
    card = build_model(cut, dev).init(torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        for name, p in card.named_parameters():
            if name.endswith(("wq", "wk")):
                p.mul_(0.125)
    batch = serve.prompt_batch(cut, 2, 24, seed=2)
    # next-token labels: with its own tokens as labels the tied head of a
    # shallow cut predicts each with probability 1.0 and the gradient is 0
    labels = np.roll(batch["tokens"], -1, axis=1)

    def logits(m, b):
        with torch.no_grad():
            if cut.is_encoder_decoder:
                h = m._decoder(b["tokens"], m.encode(b["audio_feats"]))
                return logits_from_tied(m.embedding, h, cut.vocab_size)
            return m.logits(b)[0]

    def source(m, b):
        if cut.is_encoder_decoder:
            return "cross maps", m.cross_attention_maps(b), 1e-5
        maps = m.attention_maps(b)
        if maps is not None:
            return "attention maps", maps, 1e-5
        tokens = torch.as_tensor(b["tokens"], device=m.device).long()
        return "input saliency", saliency.input_saliency(
            stack_loss, m, {"labels": labels,
                            "embeddings": m.embedding[tokens].detach()}), \
            1e-4

    full = logits(card, batch)
    prompt = {k: (v[:, :16] if k == "tokens" else v) for k, v in
              batch.items()}
    if cut.is_encoder_decoder:
        cache = card.init_cache(2, enc_len=batch["audio_feats"].shape[1])
    else:
        cache = card.init_cache(2, 32)
    lp, cache = card.prefill(prompt, cache)
    steps = [(lp[:, 0], full[:, 15])]
    for pos in range(16, 24):
        ld, cache = card.decode_step(cache, batch["tokens"][:, pos:pos + 1],
                                     pos)
        steps.append((ld[:, 0], full[:, pos]))
    err = max(float((got - want).abs().max()) for got, want in steps)
    if not all(bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all())
               for got, want in steps):
        fail(f"{cfg.name}: decode leaves teacher forcing (max err {err})")
    cpu = build_model(cut, "cpu")
    cpu.load_state_dict(card.state_dict())
    v = cut.vocab_size                  # the pad columns are −2e38 on both
    want = logits(cpu, batch)[..., :v]
    scale = max(1.0, float(want.abs().max()))
    e_logits = float((full[..., :v].cpu() - want).abs().max())
    what, got_map, tol = source(card, batch)
    e_map = float((got_map.cpu() - source(cpu, batch)[1]).abs().max())
    if e_logits > 1e-4 * scale or e_map > tol:
        fail(f"{cfg.name}: the card's float32 cut differs from the CPU "
             f"(logits {e_logits} at scale {scale}, {what} {e_map})")
    if not float(got_map.max()) > 0:
        fail(f"{cfg.name}: the cut's {what} is all zero")
    print(f"other check {cfg.name}: {cut.num_layers}-layer float32 cut at "
          f"full width: prefill + 8 decode steps equal teacher forcing (max "
          f"err {err:.3e}, rtol = atol = 2e-2); card vs CPU max err logits "
          f"{e_logits:.3e} (scale {scale:.1f}, atol 1e-4 of it), {what} "
          f"{e_map:.3e} (atol {tol:g}), TF32 off ({smi})")


def other_harvest(torch, model, cfg, arch, dev, n=None):
    """``n`` (default ``OTHER_MASKS[arch]``) of the family's masks as its
    source makes them, in batches →
    (host float32 (n, 224, 224), seconds, what): recurrentgemma's last
    local layer (``attention_maps``, window 2048 > 224) head-averaged;
    mamba2's ``input_saliency`` on a 16 x 14 grid resized; whisper's
    ``cross_attention_maps`` (448 tokens x 1,500 frames) head-averaged
    and resized.  Batches come through ``PrefetchIterator``."""
    from repro_torch.core import saliency
    from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMData
    n, bs = n or OTHER_MASKS[arch], OTHER_BATCH[arch]
    if cfg.is_encoder_decoder:
        data = SyntheticLMData(cfg, WHISPER_FRAMES, bs, seed=0)
        source = (data.batch_at(i) for i in range(n // bs))

        def masks_of(b):
            return saliency.resize_mask(saliency.last_layer_attention(
                model.cross_attention_maps(b)), H, W)
        what = (f"cross_attention_maps (B, {cfg.num_heads}, "
                f"{cfg.max_decode_len}, {WHISPER_FRAMES}) -> head mean + "
                f"normalize01 -> resize_mask {H}x{W}")
    else:
        data = SyntheticLMData(cfg, H, n, seed=0).batch_at(0)
        source = ({k: v[i:i + bs] for k, v in data.items()}
                  for i in range(0, n, bs))
        if arch == "mamba2_13b":
            def masks_of(b):
                tokens = torch.as_tensor(b["tokens"], device=dev).long()
                scores = saliency.input_saliency(stack_loss, model, {
                    **b, "embeddings": model.embedding[tokens].detach()})
                return saliency.resize_mask(saliency.tokens_to_grid(
                    scores.float(), 16, 14), H, W)
            what = (f"input_saliency -> tokens_to_grid 16x14 -> resize_mask "
                    f"{H}x{W}")
        else:
            def masks_of(b):
                return saliency.last_layer_attention(model.attention_maps(b))
            last = max(i for i, k in enumerate(model.kinds)
                       if k in ("global", "local"))
            what = (f"attention_maps of layer {last} ({model.kinds[last]}, "
                    f"window {cfg.local_window}) -> last_layer_attention")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch.cat([masks_of(b) for b in PrefetchIterator(source, depth=2)])
    torch.cuda.synchronize()
    return out.cpu().numpy(), time.perf_counter() - t0, what


def other_phase(torch, dev, smi) -> None:
    """Phase 12: recurrentgemma-2b, mamba2-1.3b and whisper-large-v3 at
    full width and depth (bf16, random weights from generator seed 0), one
    after another: build, serve (prefill and 32 greedy decode steps), the
    float32 cut's checks, harvest masks the way the family's source makes
    them, then phase 10's index-and-query window over them."""
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import count_params

    t_phase = time.perf_counter()
    for arch in OTHER_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_arch = time.perf_counter()
        cfg = load_arch(arch)
        t0 = time.perf_counter()
        model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = count_params(model)
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        if n_params != OTHER_PARAMS[arch]:
            fail(f"{cfg.name}: {n_params:,} parameters, the reference's "
                 f"init has {OTHER_PARAMS[arch]:,}")
        layers = (f"{cfg.enc_layers} + {cfg.dec_layers} layers"
                  if cfg.is_encoder_decoder else
                  f"{cfg.num_layers} layers {'/'.join(cfg.layer_pattern)}")
        print(f"other model {cfg.name}: {layers}, d_model {cfg.d_model}, "
              f"{cfg.dtype}: {n_params:,} parameters, {n_bytes:,} B; random "
              f"init {time.perf_counter() - t0:.1f} s ({smi})")

        # -- serve: prefill, then greedy decode ------------------------------
        prompt = other_prompt(serve, cfg)
        serve.greedy_generate(model, prompt, 2)              # warm-up
        out = serve.greedy_generate(model, prompt, SERVE_STEPS + 1)
        if not out["finite"]:
            fail(f"{cfg.name} serve: non-finite logits")
        b, p_len = prompt["tokens"].shape
        cache = (model.init_cache(b, enc_len=WHISPER_FRAMES)
                 if cfg.is_encoder_decoder else
                 model.init_cache(b, p_len + SERVE_STEPS + 1))
        bound_ms = float(np.mean([decode_bytes(model, cache, pos)
                                  for pos in range(p_len,
                                                   p_len + SERVE_STEPS)])
                         ) / PEAK_BYTES_S * 1e3
        del cache
        step_ms = out["decode_s"] / SERVE_STEPS * 1e3
        frames = (f"{WHISPER_FRAMES} frames + " if cfg.is_encoder_decoder
                  else "")
        print(f"other serve {cfg.name}: prefill {b}x({frames}{p_len} tokens) "
              f"{out['prefill_s'] * 1e3:.3f} ms; {SERVE_STEPS} greedy decode "
              f"steps x{b}: {step_ms:.3f} ms a step, "
              f"{SERVE_STEPS * b / out['decode_s']:.1f} tok/s (bound "
              f"{bound_ms:.3f} ms a step: the weights it reads, the caches "
              f"up to the step's position and the states at 3.35 TB/s); "
              f"logits finite; sample "
              f"{out['tokens'][0, :8].tolist()} ({smi})")
        other_cut_checks(torch, cfg, dev, smi)

        # -- harvest ---------------------------------------------------------
        if arch == "mamba2_13b" and model.attention_maps(
                {"tokens": prompt["tokens"][:1, :8]}) is not None:
            fail("mamba2: attention_maps of an attention-free stack is not "
                 "None")
        model.requires_grad_(False)
        masks, harvest_s, what = other_harvest(torch, model, cfg, arch, dev)
        n = OTHER_MASKS[arch]
        if masks.shape != (n, H, W) or masks.dtype != np.float32:
            fail(f"{cfg.name}: masks {masks.shape} {masks.dtype}")
        # input saliency in bf16 tops out at 1.0 (normalize01's fault)
        top_ok = masks.max() <= 1 if arch == "mamba2_13b" else masks.max() < 1
        if not (np.isfinite(masks).all() and masks.min() >= 0 and top_ok):
            fail(f"{cfg.name}: masks are not finite values in [0, 1)")
        print(f"other harvest {cfg.name}: {n} masks {H}x{W} float32 via "
              f"{what}, {OTHER_BATCH[arch]} a batch, in {harvest_s:.3f} s "
              f"({n / harvest_s:.1f} masks/s); values in [{masks.min()}, "
              f"{masks.max()}]; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
        del model, out
        gc.collect()
        torch.cuda.empty_cache()

        # -- index, then query: one launch window ----------------------------
        index_and_query(torch, dev, masks, n // 2, f"other {cfg.name}", smi)
        print(f"other {cfg.name}: {time.perf_counter() - t_arch:.1f} s")
    print(f"other producers phase: {time.perf_counter() - t_phase:.1f} s")


# -- 13. the DeepSeek family: MLA, MoE, the dense prefix and the MTP head -----

def expert_harvest(torch, model, dev, n):
    """``n`` expert-utilisation masks (host float32 (n, 224, 224)): 224-token
    ``SyntheticLMData`` sequences in batches of ``EXPERT_BATCH`` through
    ``PrefetchIterator``, the last MoE layer's router probabilities
    (``router_probs``, (B, 224, E) float32), ``expert_utilization_map``
    onto 224x224 → (masks, seconds, what)."""
    from repro_torch.core import saliency
    from repro_torch.data.pipeline import PrefetchIterator, SyntheticLMData
    data = SyntheticLMData(model.cfg, H, n, seed=0).batch_at(0)
    source = ({k: v[i:i + EXPERT_BATCH] for k, v in data.items()}
              for i in range(0, n, EXPERT_BATCH))
    last = max(i for i, blk in enumerate(model.blocks) if blk.use_moe)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch.cat([saliency.expert_utilization_map(model.router_probs(b),
                                                     H, W)
                     for b in PrefetchIterator(source, depth=2)])
    torch.cuda.synchronize()
    what = (f"router_probs of layer {last} (B, {H}, "
            f"{model.cfg.num_experts}) float32 -> expert_utilization_map "
            f"{H}x{W}")
    return out.cpu().numpy(), time.perf_counter() - t0, what


def deepseek_cut_checks(torch, cfg, dev, smi) -> None:
    """A 2-layer float32 cut of deepseek-v2 at full width (1 dense + 1 MoE
    layer, ~19.3 GB; random weights from generator seed 1, the reference's
    init scales), TF32 off: prefill of 2 x 16 tokens (capacity 1 a call,
    the configs' own factor, so assignments drop) and 4 decode steps on
    the card against the port's CPU path with the same weights (logits
    1e-4 of their scale), and the router probabilities the masks come
    from (1e-5); then at capacity factor 100 (nothing drops) prefill + 8
    decode steps against teacher forcing (2e-2, as the reference's test:
    the absorbed MLA decode against the materialised one)."""
    import dataclasses
    import gc
    from repro_torch.launch import serve
    from repro_torch.models import build_model, moe
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    card = build_model(cut, dev).init(torch.Generator(dev).manual_seed(1))
    cpu = build_model(cut, "cpu")
    cpu.load_state_dict(card.state_dict())
    tokens = serve.prompt_batch(cut, 2, 24, seed=2)["tokens"]
    prompt = {"tokens": tokens[:, :16]}
    probs = cpu.router_probs(prompt)
    _, ids = moe.top_k(probs.reshape(-1, cut.num_experts), cut.top_k)
    counts = torch.bincount(ids.reshape(-1), minlength=cut.num_experts)
    cap = moe.capacity(cut, 32)
    n_drop = int((counts - cap).clamp(min=0).sum())
    if n_drop == 0:
        fail(f"deepseek cut: no assignment dropped at capacity {cap}")
    outs = {}
    for name, m in (("card", card), ("cpu", cpu)):
        cache = m.init_cache(2, 24)
        lp, cache = m.prefill(prompt, cache)
        steps = [lp[:, 0]]
        for pos in range(16, 20):
            ld, cache = m.decode_step(cache, tokens[:, pos:pos + 1], pos)
            steps.append(ld[:, 0])
        outs[name] = torch.stack([x.cpu() for x in steps])[..., :cut.vocab_size]
    want = outs["cpu"]
    scale = max(1.0, float(want.abs().max()))
    e_serve = float((outs["card"] - want).abs().max())
    e_probs = float((card.router_probs(prompt).cpu() - probs).abs().max())
    if not torch.isfinite(outs["card"]).all():
        fail("deepseek cut: non-finite logits on the card")
    if e_serve > 1e-4 * scale or e_probs > 1e-5:
        fail(f"deepseek cut: the card differs from the CPU (prefill + "
             f"decode logits {e_serve} at scale {scale}, router "
             f"probabilities {e_probs})")
    del cpu
    gc.collect()
    with torch.no_grad():
        full, _ = card.logits({"tokens": tokens})
    off = float((outs["card"][0] - full[:, 15, :cut.vocab_size].cpu()
                 ).abs().max())
    whole = build_model(dataclasses.replace(cut, capacity_factor=100.0), dev)
    whole.load_state_dict(card.state_dict())
    del card
    with torch.no_grad():
        full, _ = whole.logits({"tokens": tokens})
    cache = whole.init_cache(2, 24)
    lp, cache = whole.prefill(prompt, cache)
    steps = [(lp[:, 0], full[:, 15])]
    for pos in range(16, 24):
        ld, cache = whole.decode_step(cache, tokens[:, pos:pos + 1], pos)
        steps.append((ld[:, 0], full[:, pos]))
    err = max(float((got - w).abs().max()) for got, w in steps)
    if not all(bool(((got - w).abs() <= 2e-2 + 2e-2 * w.abs()).all())
               for got, w in steps):
        fail(f"deepseek cut: decode leaves teacher forcing (max err {err})")
    del whole
    print(f"deepseek check: 2-layer float32 cut at full width (1 dense + 1 "
          f"MoE): prefill 2x16 (capacity {cap}: {n_drop} of "
          f"{32 * cut.top_k} "
          f"assignments dropped) + 4 decode steps, card vs CPU max err "
          f"{e_serve:.3e} (scale {scale:.1f}, atol 1e-4 of it), router "
          f"probabilities {e_probs:.3e} (atol 1e-5); prefill's last logits "
          f"{off:.3f} off teacher forcing (capacity per call, as the "
          f"reference); at capacity factor 100 prefill + 8 decode steps "
          f"equal teacher forcing (max err {err:.3e}, rtol = atol = 2e-2), "
          f"TF32 off ({smi})")


def deepseek_phase(torch, dev, smi) -> None:
    """Phase 13: deepseek-v2-236b at full width cut to 8 layers (1 dense +
    7 MoE; bf16, random weights from generator seed 0) serves prefill and
    32 greedy decode steps, harvests expert-utilisation masks from layer
    7's router and indexes and queries them in a launch window of its own;
    then the float32 cut's checks; then deepseek-v3-671b at full width cut
    to 4 layers and its MTP head: a prefill and one loss with
    ``labels_mtp``."""
    import dataclasses
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.layers import count_params

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(load_arch(DEEPSEEK_ARCH),
                              num_layers=DEEPSEEK_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(model)
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if n_params != DEEPSEEK_PARAMS:
        fail(f"{cfg.name}: {n_params:,} parameters at {DEEPSEEK_LAYERS} "
             f"layers, the reference's init has {DEEPSEEK_PARAMS:,}")
    moe_layers = sum(blk.use_moe for blk in model.blocks)
    print(f"deepseek model {cfg.name}: {cfg.num_layers} layers ("
          f"{cfg.num_layers - moe_layers} dense + {moe_layers} MoE) of "
          f"{load_arch(DEEPSEEK_ARCH).num_layers}, d_model {cfg.d_model}, "
          f"{cfg.num_heads} MLA heads (q/kv LoRA {cfg.q_lora_rank}/"
          f"{cfg.kv_lora_rank}), {cfg.num_experts} experts top-{cfg.top_k} "
          f"+ {cfg.num_shared_experts} shared (d_ff {cfg.moe_d_ff}; dense "
          f"{cfg.d_ff}), vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{n_params:,} parameters, {n_bytes:,} B; random init "
          f"{time.perf_counter() - t0:.1f} s ({smi})")

    # -- 13a. serve: prefill, then greedy decode ------------------------------
    prompt = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    serve.greedy_generate(model, prompt, 2)              # warm-up
    out = serve.greedy_generate(model, prompt, SERVE_STEPS + 1)
    if not out["finite"]:
        fail(f"{cfg.name} serve: non-finite logits")
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_STEPS + 1)
    bound_ms = float(np.mean([decode_bytes(model, cache, pos) for pos in
                              range(SERVE_PROMPT, SERVE_PROMPT + SERVE_STEPS)])
                     ) / PEAK_BYTES_S * 1e3
    del cache
    step_ms = out["decode_s"] / SERVE_STEPS * 1e3
    print(f"deepseek serve {cfg.name}: prefill {SERVE_BATCH}x{SERVE_PROMPT} "
          f"{out['prefill_s'] * 1e3:.3f} ms; {SERVE_STEPS} greedy decode "
          f"steps x{SERVE_BATCH}: {step_ms:.3f} ms a step, "
          f"{SERVE_STEPS * SERVE_BATCH / out['decode_s']:.1f} tok/s (bound "
          f"{bound_ms:.3f} ms a step: every expert of every layer at "
          f"capacity 1, the weights and the compressed cache up to the "
          f"step's position at 3.35 TB/s); logits finite; sample "
          f"{out['tokens'][0, :8].tolist()} ({smi})")

    # -- 13b. harvest expert-utilisation masks --------------------------------
    model.requires_grad_(False)
    masks, harvest_s, what = expert_harvest(torch, model, dev, N_EXPERT_MASKS)
    if masks.shape != (N_EXPERT_MASKS, H, W) or masks.dtype != np.float32:
        fail(f"{cfg.name}: masks {masks.shape} {masks.dtype}")
    if not (np.isfinite(masks).all() and masks.min() >= 0 and
            masks.max() < 1):
        fail(f"{cfg.name}: masks are not finite values in [0, 1)")
    print(f"deepseek harvest {cfg.name}: {N_EXPERT_MASKS} masks {H}x{W} "
          f"float32 via {what}, {EXPERT_BATCH} a batch, in {harvest_s:.3f} "
          f"s ({N_EXPERT_MASKS / harvest_s:.1f} masks/s, "
          f"{N_EXPERT_MASKS * H / harvest_s:.0f} tok/s); values in "
          f"[{masks.min()}, {masks.max()}]; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
    del model, out
    gc.collect()
    torch.cuda.empty_cache()

    # -- 13c. index, then query: one launch window ----------------------------
    t0 = time.perf_counter()
    index_and_query(torch, dev, masks, N_EXPERT_MASKS // 2, "deepseek", smi)
    print(f"deepseek window: {time.perf_counter() - t0:.1f} s")
    del masks

    # -- 13d. the float32 cut: card vs CPU, teacher forcing -------------------
    t0 = time.perf_counter()
    deepseek_cut_checks(torch, cfg, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"deepseek cut checks: {time.perf_counter() - t0:.1f} s")

    # -- 13e. deepseek-v3: the dense prefix, MoE and the MTP head -------------
    cfg3 = dataclasses.replace(load_arch(DEEPSEEK_V3_ARCH),
                               num_layers=DEEPSEEK_V3_LAYERS)
    t0 = time.perf_counter()
    model = build_model(cfg3, dev).init(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = count_params(model)
    if n_params != DEEPSEEK_V3_PARAMS:
        fail(f"{cfg3.name}: {n_params:,} parameters at {DEEPSEEK_V3_LAYERS} "
             f"layers, the reference's init has {DEEPSEEK_V3_PARAMS:,}")
    init_s = time.perf_counter() - t0
    prompt = serve.prompt_batch(cfg3, SERVE_BATCH, SERVE_PROMPT)
    model.prefill(prompt, model.init_cache(SERVE_BATCH, SERVE_PROMPT))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = model.prefill(prompt, model.init_cache(SERVE_BATCH,
                                                       SERVE_PROMPT))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()):
        fail(f"{cfg3.name}: non-finite prefill logits")
    batch = SyntheticLMData(cfg3, 512, 4, seed=0).batch_at(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, metrics = model.loss(batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    loss_ms = (time.perf_counter() - t0) * 1e3
    if set(metrics) != {"ce", "aux", "ce_mtp", "loss"} or not all(
            np.isfinite(v) for v in metrics.values()):
        fail(f"{cfg3.name}: loss metrics {metrics}")
    n_moe = sum(blk.use_moe for blk in model.blocks)
    print(f"deepseek model {cfg3.name}: {cfg3.num_layers} layers ("
          f"{cfg3.num_layers - n_moe} dense + {n_moe} MoE, "
          f"{cfg3.num_experts} experts top-{cfg3.top_k}) + the MTP "
          f"head, d_model {cfg3.d_model}: {n_params:,} parameters; random "
          f"init {init_s:.1f} s; prefill {SERVE_BATCH}x{SERVE_PROMPT} "
          f"{prefill_ms:.3f} ms, logits finite; loss of 4 x 512 "
          f"SyntheticLMData tokens with labels_mtp in {loss_ms:.3f} ms: "
          + ", ".join(f"{k} {v:.6f}" for k, v in metrics.items()) +
          f"; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"({smi})")
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"deepseek phase: {time.perf_counter() - t_phase:.1f} s")


# -- 14. the mesh: the dry-run, the MaskSearch cells, a sharded granite ------

# the MaskSearch cells' cuts on one card (the reference's MS_DB otherwise)
MESH_CHI_BASE = 16384       # masks whose CHI tables are built, then tiled
MESH_CHI_TILE = 128         # → 2,097,152 rows, cut from 4,194,304
MESH_GROUPS = 65536         # IoU groups, cut from 262,144
MESH_CHUNK = 2048
MESH_K = 64


def blob_masks(torch, gen, n, h, w, dev):
    """``n`` (h, w) float32 masks in [0, 1): one Gaussian blob each, at a
    random centre and width, drawn on the card from ``gen``."""
    c = torch.rand((n, 2, 1, 1), generator=gen, device=dev)
    s = 0.05 + 0.25 * torch.rand((n, 1, 1), generator=gen, device=dev)
    y = torch.linspace(0, 1, h, device=dev)[None, :, None]
    x = torch.linspace(0, 1, w, device=dev)[None, None, :]
    d2 = (y - c[:, 0]) ** 2 + (x - c[:, 1]) ** 2
    return (torch.exp(-d2 / (2 * s * s)) * 0.999).to(torch.float32)


def random_rois(torch, gen, n, h, w, dev):
    """(n, 4) int32 ROIs (r0, c0, r1, c1), 16 to 127 pixels a side."""
    lo = torch.randint(0, h // 2, (n, 2), generator=gen, device=dev)
    size = torch.randint(16, h // 2, (n, 2), generator=gen, device=dev)
    hi = torch.minimum(lo + size, torch.tensor([h, w], device=dev))
    return torch.cat([lo, hi], 1).to(torch.int32)


def cell_line(torch, cell, run, cuts, floor, smi):
    """Time ``run`` (the cell's step) on the card and print it beside the
    dry-run's memory term for the cell (``roofline.extract.reckon_cost``:
    the bytes a step reads for a mean ROI, over 3.35 TB/s) and beside
    ``floor``: (ms, what) of the bytes the step must move for these
    inputs (their ROI pixels, the corner sectors), with its share."""
    from repro_torch.roofline.extract import reckon_cost
    nbytes = reckon_cost(cell).bytes_accessed
    ms = time_ms(torch, run, reps=3, warmup=1)
    bound = nbytes / PEAK_BYTES_S * 1e3
    print(f"mesh cell {cell.shape_id}: {ms:.4f} ms on a (1,) mesh of "
          f"cuda:0; the dry-run's reckoned bytes {nbytes / 1e9:.3f} GB / "
          f"3.35 TB/s = {bound:.4f} ms; the bytes these inputs need "
          f"({floor[1]}) {floor[0]:.4f} ms, {floor[0] / ms:.3f} of that "
          f"floor; {cuts} ({smi})")


def plain_in_parts(torch, k, args, rows) -> float:
    """Max abs error of kernel ``k``'s call on ``args`` against its plain
    version on the same inputs, the plain version run ``rows`` rows at a
    time (row-wise independent; whole, its temporaries would not fit)."""
    got = k(*args)
    got = got if isinstance(got, tuple) else (got,)
    err = 0.0
    for lo in range(0, args[0].shape[0], rows):
        part = (args[0][lo:lo + rows], args[1][lo:lo + rows]) + args[2:]
        want = k.plain(*part)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = max(err, max_abs_err(torch, g[lo:lo + rows], w))
    return err


def masksearch_mesh_cells(torch, dev, ops, smi) -> dict:
    """14b: the dry-run's four MaskSearch cells through the port's
    ``core/distributed.py`` steps on a (1,) mesh of ``cuda:0``, one cell at
    a time on data drawn on the card (cut where the reference's size does
    not fit one card).  Each step runs once in a launch window of its own,
    then is timed; the kernels' calls are held against their plain
    versions at tolerance 0 → launches per kernel."""
    import gc
    from repro_torch.core import CHIConfig, chi as chi_lib
    from repro_torch.core import distributed as dist
    from repro_torch.kernels import ref
    from repro_torch.launch.specs import MS_DB, build_masksearch_cells

    mesh = dist.make_mesh((1,), ("data",), [dev])
    h, w = MS_DB["height"], MS_DB["width"]
    cfg = CHIConfig(grid=MS_DB["grid"], num_bins=MS_DB["num_bins"],
                    height=h, width=w)
    n_rows = MESH_CHI_BASE * MESH_CHI_TILE
    cells = {c.shape_id: c for c in build_masksearch_cells(
        mesh, [dev], db=dict(n_masks=n_rows, groups=MESH_GROUPS))}
    gen = torch.Generator(dev).manual_seed(14)
    launches = {k: 0 for k in ("cp_count", "mask_agg_counts")}

    def window(fn):
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = ops.launch_counts()
        for k in launches:
            launches[k] += got[k]
        return out, {k: v for k, v in got.items() if v}

    # verify_64k at the reference's size: 65,536 x 256x256 float32
    v = MS_DB["verify_batch"]
    masks = torch.rand((v, h, w), generator=gen, device=dev)
    rois = random_rois(torch, gen, v, h, w, dev)
    lv, uv = torch.tensor(0.25), torch.tensor(0.75)
    cell = cells["verify_64k"]
    counts, got = window(lambda: cell.step_fn(masks, rois, lv, uv))
    if got.get("cp_count", 0) < 1 or counts.shape != (v,):
        fail(f"mesh cell verify_64k: launches {got}")
    err = plain_in_parts(torch, ops.cp_count, (masks, rois, lv, uv), 8192)
    if err != 0:
        fail(f"mesh cell verify_64k: cp_count differs from its plain "
             f"version (max abs err {err})")
    print(f"mesh parity cp_count (verify_64k): {tuple(masks.shape)} float32 "
          f"equal to its plain version (max abs err 0; plain run 8,192 rows "
          f"at a time); launches {got}")
    cell_line(torch, cell, lambda: cell.step_fn(masks, rois, lv, uv),
              "no cut: the reference's 65,536 masks (17.18 GB)",
              (bound_of(torch, ref, "cp_count", (masks, rois))[0],
               "cp_count's ROI pixels"), smi)
    del masks, rois, counts
    gc.collect()
    torch.cuda.empty_cache()

    # filter_bounds and topk_bounds: CHI tables of MESH_CHI_BASE blobs,
    # built with chi_cell_hist and tiled MESH_CHI_TILE times
    base = torch.cat([chi_lib.build_chi(blob_masks(
        torch, gen, MESH_CHUNK, h, w, dev), cfg)
        for _ in range(MESH_CHI_BASE // MESH_CHUNK)])
    base_rois = random_rois(torch, gen, MESH_CHI_BASE, h, w, dev)
    lv, uv = 0.5, 1.0
    lb, ub = chi_lib.chi_bounds(base.cpu(), cfg, base_rois.cpu().numpy(),
                                lv, uv)
    lb, ub = lb.numpy(), ub.numpy()
    # a threshold inside the nonzero upper bounds splits the rows three
    # ways: accepted, rejected and undecided
    thr = int(np.median(ub[ub > 0])) if (ub > 0).any() else 1
    h_acc = ub < thr
    h_und = ~(h_acc | (lb >= thr))
    if h_acc.all() or not h_und.any() or (h_acc | h_und).all():
        fail(f"mesh cell filter_bounds: threshold {thr} does not split the "
             f"host's verdicts")
    tables = base.repeat(MESH_CHI_TILE, 1, 1, 1)
    rois = base_rois.repeat(MESH_CHI_TILE, 1)
    del base
    rb, cb = torch.as_tensor(cfg.row_bounds), torch.as_tensor(cfg.col_bounds)
    ks = torch.as_tensor(dist.value_ks(cfg, lv, uv))
    cell = cells["filter_bounds_4m"]
    (acc, und, counts), got = window(
        lambda: cell.step_fn(tables, rois, rb, cb, ks, thr))
    first = slice(0, MESH_CHI_BASE)
    if not (np.array_equal(acc[first].cpu().numpy(), h_acc) and
            np.array_equal(und[first].cpu().numpy(), h_und)):
        fail("mesh cell filter_bounds: verdicts differ from the host's bounds")
    want = [MESH_CHI_TILE * int(h_acc.sum()), MESH_CHI_TILE * int(h_und.sum())]
    if counts.cpu().tolist() != want:
        fail(f"mesh cell filter_bounds: counts {counts.tolist()}, want {want}")
    print(f"mesh cell filter_bounds: {n_rows:,} rows, threshold {thr}: "
          f"accept {want[0]:,}, undecided {want[1]:,} ({MESH_CHI_TILE}x the host's "
          f"bounds on the first {MESH_CHI_BASE:,}, verdicts equal there)")
    cut = (f"cut: {n_rows:,} of 4,194,304 rows ({tables.numel() * 4 / 1e9:.1f}"
           f" of 82.4 GB of CHI tables)")
    # the bounds gather 8 corners for each of lb and ub: 16 int32 a row,
    # each in a 32-byte sector of its own; the ROIs read, two flags written
    corners = (n_rows * (16 * 32 + 16 + 2) / PEAK_BYTES_S * 1e3,
               "16 corner sectors, the ROI and two flags a row")
    cell_line(torch, cell, lambda: cell.step_fn(tables, rois, rb, cb, ks,
                                                thr), cut, corners, smi)
    del acc, und
    ids = torch.arange(n_rows, dtype=torch.int32, device=dev)
    cell = cells["topk_bounds_4m"]
    (_, _, tau, surv), got = window(
        lambda: cell.step_fn(tables, rois, rb, cb, ks, ids))
    tau_h = np.sort(np.tile(lb, MESH_CHI_TILE))[::-1][MESH_K - 1]
    h_surv = ub >= tau_h
    if int(tau) != int(tau_h) or not np.array_equal(
            surv[first].cpu().numpy(), h_surv) or \
            int(surv.sum()) != MESH_CHI_TILE * int(h_surv.sum()):
        fail("mesh cell topk_bounds: tau or survivors differ from the "
             "host's bounds")
    print(f"mesh cell topk_bounds: k {MESH_K}, tau {int(tau)}, "
          f"{int(surv.sum()):,} survivors ({MESH_CHI_TILE}x the host's "
          f"{int(h_surv.sum()):,}, equal on the first {MESH_CHI_BASE:,})")
    cell_line(torch, cell, lambda: cell.step_fn(tables, rois, rb, cb, ks,
                                                ids), cut, corners, smi)
    del tables, rois, ids, surv
    gc.collect()
    torch.cuda.empty_cache()

    # iou_agg: MESH_GROUPS groups of 2 x 256x256 float32
    s = MS_DB["group_size"]
    gm = torch.empty((MESH_GROUPS, s, h, w), device=dev)
    for lo in range(0, MESH_GROUPS, MESH_CHUNK):
        gm[lo:lo + MESH_CHUNK] = torch.rand((MESH_CHUNK, s, h, w),
                                            generator=gen, device=dev)
    grois = random_rois(torch, gen, MESH_GROUPS, h, w, dev)
    t = torch.tensor(0.5)
    cell = cells["iou_agg_256k"]
    iou, got = window(lambda: cell.step_fn(gm, grois, t))
    if got.get("mask_agg_counts", 0) < 1 or not bool(
            ((iou >= 0) & (iou <= 1)).all()):
        fail(f"mesh cell iou_agg: launches {got} or IoU outside [0, 1]")
    err = plain_in_parts(torch, ops.mask_agg_counts, (gm, grois, t), 4096)
    if err != 0:
        fail(f"mesh cell iou_agg: mask_agg_counts differs from its plain "
             f"version (max abs err {err})")
    print(f"mesh parity mask_agg_counts (iou_agg): {tuple(gm.shape)} float32 "
          f"equal to its plain version (max abs err 0; plain run 4,096 "
          f"groups at a time); launches {got}")
    cell_line(torch, cell, lambda: cell.step_fn(gm, grois, t),
              f"cut: {MESH_GROUPS:,} of 262,144 groups "
              f"({gm.numel() * 4 / 1e9:.1f} of 137.4 GB)",
              (bound_of(torch, ref, "mask_agg_counts", (gm, grois))[0],
               "mask_agg_counts' ROI pixels"), smi)
    del gm, grois, iou
    gc.collect()
    torch.cuda.empty_cache()
    return launches


MESH_STEPS = 8              # greedy decode steps of the mesh's decodes


def mesh_greedy(torch, model, prompt, steps, mesh=None, cfg=None):
    """``model``'s greedy tokens on ``prompt`` (host arrays; for whisper
    its frames too), prefill then ``steps`` decode steps, each step's
    argmax kept → ((B, steps) tokens on the card, seconds of the second
    of two runs, the first a warm-up).  With a mesh (DTensor parameters,
    the activation rules installed) the prompt is placed by
    ``distribute_batch`` and the cache by ``cache_sharding_tree``, and
    kept there after every call."""
    from repro_torch.launch import sharding as sh
    from repro_torch.train.train_loop import replication
    b, p_len = np.shape(prompt["tokens"])
    if mesh is None:
        prompt = {k: torch.as_tensor(v, device=model.device)
                  for k, v in prompt.items()}
        place = lambda c: c                                # noqa: E731
    else:
        prompt = sh.distribute_batch(mesh, prompt, cfg)
        place = lambda c: sh.distribute_cache(mesh, c)     # noqa: E731
    pos0 = p_len + (model.cfg.num_patches or 0)
    for _ in range(2):
        cache = (model.init_cache(b, enc_len=np.shape(
            prompt["audio_feats"])[1]) if model.cfg.is_encoder_decoder
            else model.init_cache(b, p_len + steps))
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with replication(model):
            logits, cache = model.prefill(prompt, place(cache))
            for i in range(steps):
                nxt = logits[:, -1:].argmax(-1)
                out.append(nxt.full_tensor() if hasattr(nxt, "full_tensor")
                           else nxt)
                logits, cache = model.decode_step(place(cache), nxt,
                                                  pos0 + i)
        torch.cuda.synchronize()
        del cache, logits
    return torch.cat(out, 1), time.perf_counter() - t0


def granite_built(torch, cfg, dev, seed=0):
    """granite (or a cut of it) from generator seed ``seed``, ``wq`` and
    ``wk`` at an eighth of the init scale (phase 11's convention)."""
    from repro_torch.models import build_model
    m = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(seed))
    with torch.no_grad():
        for blk in m.blocks:
            blk.mixer.wq.mul_(0.125)
            blk.mixer.wk.mul_(0.125)
    return m


def sharded_granite(torch, dev, mesh, smi) -> None:
    """14c-d: granite-3.0-2B at full width on the (1, 1) ("data", "model")
    DeviceMesh: decode with the cache placed by ``cache_sharding_tree``
    against the unsharded decode (tokens equal); phase 11's train step
    sharded against unsharded (loss within 1e-3), 2 sharded steps; a
    2-layer float32 cut's updated parameters against the unsharded
    step's (1e-5 of scale, ``params_within_rule``)."""
    import dataclasses
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import sharding as sh
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import (make_loss_and_grads,
                                              make_train_step)

    cfg = load_arch(PRODUCER_ARCH)

    def built(c, seed=0):
        return granite_built(torch, c, dev, seed)

    # 14c. decode: 8 x 128 prompt, 8 greedy steps
    torch.cuda.reset_peak_memory_stats(dev)
    model = built(cfg)
    prompt = {"tokens": SyntheticLMData(cfg, SERVE_PROMPT, SERVE_BATCH)
              .batch_at(0)["tokens"]}
    want, plain_s = mesh_greedy(torch, model, prompt, MESH_STEPS)
    sh.distribute_params(model, mesh, cfg)
    sh.install_activation_rules(mesh, cfg)
    shape = (SERVE_BATCH, SERVE_PROMPT + MESH_STEPS, cfg.num_kv_heads,
             cfg.head_dim)
    spec = sh.cache_spec(mesh, "k", shape)
    placements = sh.cache_sharding_tree(mesh, model.init_cache(1, 8))[0]
    got, dec_s = mesh_greedy(torch, model, prompt, MESH_STEPS, mesh, cfg)
    if not torch.equal(got, want):
        fail("mesh decode: tokens differ from the unsharded decode")
    print(f"mesh decode: {cfg.name} at full width on a (1, 1) (data, model) "
          f"DeviceMesh, params by param_sharding_tree, the cache by "
          f"cache_sharding_tree (k and v: spec {spec}, on one rank "
          f"{placements['k']}): prefill {SERVE_BATCH} x "
          f"{SERVE_PROMPT} + {MESH_STEPS} greedy steps in "
          f"{dec_s * 1e3:.3f} ms (unsharded {plain_s * 1e3:.3f} ms; each "
          f"the second of two runs), tokens equal to the unsharded decode; "
          f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"({smi})")
    sh.clear_activation_rules()
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 14d. phase 11's train step, unsharded then sharded on the same
    # weights and batch
    opt_cfg = OptConfig(warmup_steps=0, total_steps=10)
    data = SyntheticLMData(cfg, TRAIN_SEQ, TRAIN_BATCH)
    model = built(cfg)
    opt = init_opt_state(model.parameters(), opt_cfg)
    opt, met = make_train_step(model, opt_cfg, microbatches=TRAIN_MICRO)(
        opt, data.batch_at(0))
    want = float(met["loss"])
    del model, opt, met
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = sh.distribute_params(built(cfg), mesh, cfg)
    sh.install_activation_rules(mesh, cfg)
    opt = init_opt_state(model.parameters(), opt_cfg)
    step = make_train_step(
        model, opt_cfg, microbatches=TRAIN_MICRO,
        place_batch=lambda b: sh.distribute_batch(mesh, b, cfg))
    recs = []
    for s in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, met = step(opt, data.batch_at(s))
        loss = float(met["loss"].full_tensor())
        recs.append((loss, (time.perf_counter() - t0) * 1e3))
        if not np.isfinite(loss):
            fail(f"mesh train step {s}: loss {loss}")
    e = rel_err(recs[0][0], want)
    if e > 1e-3:
        fail(f"mesh train: sharded loss {recs[0][0]} vs unsharded {want} "
             f"(rel err {e})")
    print(f"mesh train: {cfg.name} at full width on the (1, 1) mesh, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_MICRO} "
          f"microbatches: step 0 loss {recs[0][0]:.6f} vs unsharded "
          f"{want:.6f} (rel err {e:.3e}, limit 1e-3); "
          + "; ".join(f"step {i} {ms:.3f} ms" for i, (_, ms) in
                      enumerate(recs))
          + f"; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
          f"({smi})")
    sh.clear_activation_rules()
    del model, opt, step, met
    gc.collect()
    torch.cuda.empty_cache()

    # the 2-layer float32 cut: the updated parameters
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    data = SyntheticLMData(cut, 64, 4, seed=3)
    batch = data.batch_at(0)
    ref_m = built(cut, 1)
    _, _, grads = make_loss_and_grads(ref_m, 2)(batch)
    noisy = [(g.abs() <= 1e-5 * max(1.0, float(g.abs().max()))).cpu()
             for g in grads]
    del grads
    _, met = make_train_step(ref_m, opt_cfg, microbatches=2)(
        init_opt_state(ref_m.parameters(), opt_cfg), batch)
    m = sh.distribute_params(built(cut, 1), mesh, cut)
    sh.install_activation_rules(mesh, cut)
    _, met2 = make_train_step(
        m, opt_cfg, microbatches=2,
        place_batch=lambda b: sh.distribute_batch(mesh, b, cut))(
        init_opt_state(m.parameters(), opt_cfg), batch)
    sh.clear_activation_rules()
    got = [(n, p.full_tensor()) for n, p in m.named_parameters()]
    worst, inside = params_within_rule(torch, got, list(ref_m.parameters()),
                                       noisy, float(met["lr"]))
    e = rel_err(float(met2["loss"].full_tensor()), float(met["loss"]))
    print(f"mesh train check: 2-layer float32 cut at full width, one step "
          f"of 2 x 2 x 64 tokens sharded vs unsharded: loss rel err "
          f"{e:.3e}; params within 1e-5 of scale (max err {worst:.3e}; "
          f"where grads are under the noise {inside:.3e}) ({smi})")


def sharded_deepseek(torch, dev, mesh, smi) -> None:
    """14e-f: deepseek-v2-236b at full width cut to phase 13's 8 layers
    (bf16, 57.33 GB) on the (1, 1) mesh: greedy decode of 8 x 128 +
    ``MESH_STEPS`` steps with the cache placed by ``cache_sharding_tree``,
    tokens equal to the unsharded decode of the same weights, run first.
    Then a 2-layer float32 cut (1 dense + 1 MoE): the loss and every
    gradient on the mesh against unsharded (1e-5 of scale), the
    unsharded gradients parked on the host and compared leaf by leaf so
    that the card holds one model and one set of gradients."""
    import dataclasses
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.train.train_loop import make_loss_and_grads, replication

    # 14e. decode at full width, 8 of 60 layers
    cfg = dataclasses.replace(load_arch(DEEPSEEK_ARCH),
                              num_layers=DEEPSEEK_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev).init(torch.Generator(dev).manual_seed(0))
    prompt = serve.prompt_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    want, plain_s = mesh_greedy(torch, model, prompt, MESH_STEPS)
    sh.distribute_params(model, mesh, cfg)
    sh.install_activation_rules(mesh, cfg)
    got, dec_s = mesh_greedy(torch, model, prompt, MESH_STEPS, mesh, cfg)
    sh.clear_activation_rules()
    if not torch.equal(got, want):
        fail(f"mesh decode {cfg.name}: tokens differ from the unsharded "
             f"decode")
    experts = str(model.blocks[-1].ffn.gate.placements)
    print(f"mesh decode: {cfg.name} at full width, {DEEPSEEK_LAYERS} of 60 "
          f"layers, on the (1, 1) mesh (routed experts {experts}; the "
          f"MoE's expert-parallel dispatch and combine): prefill "
          f"{SERVE_BATCH} x {SERVE_PROMPT} + {MESH_STEPS} greedy steps in "
          f"{dec_s * 1e3:.3f} ms (unsharded {plain_s * 1e3:.3f} ms; each the "
          f"second of two runs), tokens equal to the unsharded decode; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 14f. the 2-layer float32 cut: loss and gradients
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    model = build_model(cut, dev).init(torch.Generator(dev).manual_seed(1))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"mesh train reckoned: {cut.name} 2-layer float32 cut "
          f"{n_bytes / 1e9:.2f} GB of parameters; on the card the parameters "
          f"and one set of gradients, {2 * n_bytes / 1e9:.2f} GB, the other "
          f"gradients on the host")
    if 2 * n_bytes > 70e9:
        fail(f"mesh train: {2 * n_bytes / 1e9:.2f} GB leaves no room on the "
             f"card")
    batch = SyntheticLMData(cut, 64, 2, seed=3).batch_at(0)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = make_loss_and_grads(model, 1)(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    loss = float(loss)
    ref = [g.cpu() for g in grads]
    del grads
    for p in model.parameters():
        p.grad = None
    sh.distribute_params(model, mesh, cut)
    sh.install_activation_rules(mesh, cut)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with replication(model):
        loss2, _, grads = make_loss_and_grads(
            model, 1, lambda b: sh.distribute_batch(mesh, b, cut))(batch)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    sh.clear_activation_rules()
    loss2 = float(loss2.full_tensor())
    worst = 0.0
    for g, w in zip(grads, ref):
        w = w.to(dev)
        worst = max(worst, float((g.full_tensor() - w).abs().max()) /
                    max(1.0, float(w.abs().max())))
    e = abs(loss2 - loss) / max(1.0, abs(loss))
    if e > 1e-5 or worst > 1e-5:
        fail(f"mesh train {cut.name}: loss {loss2} vs {loss} (err {e}), "
             f"gradients {worst} of scale")
    print(f"mesh train: {cut.name} 2-layer float32 cut at full width (1 "
          f"dense + 1 MoE), loss and gradients of 2 x 64 tokens on the (1, "
          f"1) mesh against unsharded: loss {loss2:.6f} (err {e:.3e} of "
          f"scale), gradients max err {worst:.3e} of scale (limit 1e-5); "
          f"{mesh_ms:.3f} ms (unsharded {plain_ms:.3f} ms); peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
    del model, grads, ref
    gc.collect()
    torch.cuda.empty_cache()


def ep_reckoned() -> None:
    """The expert-parallel bytes one rank sends in a train step
    (``sharding.ep_bytes``: reckoned from the placements, forward and
    backward of every MoE layer and microbatch; not measured): on the
    2 x 4 ("data", "model") mesh of the CPU tests, deepseek-v2 SMOKE at
    their step (2 microbatches of 4 x 16 tokens) and deepseek-v2-236b at
    train_4k (its 8 microbatches of 32 x 4,096 tokens); and the latter on
    the 16 x 16 production mesh.  Beside each, what replicating the routed
    experts would send instead (:func:`replicated`)."""
    import types
    from repro_torch.configs import SHAPES, load_arch, load_smoke
    from repro_torch.launch import sharding as sh
    from repro_torch.models.transformer import stack_plan

    def mesh(shape):
        return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=shape, ndim=2)

    spec = SHAPES["train_4k"]
    full = load_arch(DEEPSEEK_ARCH)
    mb = full.microbatches_train_4k
    for cfg, shape, micro, tokens in (
            (load_smoke(DEEPSEEK_ARCH), (2, 4), 2, 8 * 16 // 2),
            (full, (2, 4), mb, spec["global_batch"] * spec["seq_len"] // mb),
            (full, (16, 16), mb,
             spec["global_batch"] * spec["seq_len"] // mb)):
        layers = cfg.num_layers - len(stack_plan(cfg)[0])
        ep = sh.ep_bytes(mesh(shape), cfg, tokens)
        print(f"mesh ep reckoned: {cfg.name} on {shape[0]} x {shape[1]}, "
              f"{layers} MoE layers x {micro} microbatches of {tokens:,} "
              f"tokens: a call sends routing {ep['routing']:,.0f} B, "
              f"dispatch {ep['dispatch']:,.0f} B, combine "
              f"{ep['combine']:,.0f} B (forward {ep['forward']:,.0f}); a "
              f"train step {layers * micro * ep['train'] / 1e9:,.6f} GB a "
              f"rank (all-reduce, no all-to-all); replicated experts "
              f"instead: their gradients' all-reduce "
              f"{replicated(cfg, shape, layers) / 1e9:,.6f} GB a rank a "
              f"step")


def replicated(cfg, shape, layers: int) -> float:
    """The bytes one rank would send in a train step with the routed
    experts replicated instead of split: their gradients all-reduced once
    over every rank of the mesh (a ring's 2(n-1)/n), in the parameters'
    dtype; every rank would then hold all their weights."""
    n = shape[0] * shape[1]
    nbytes = (layers * 3 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff *
              (2 if cfg.dtype == "bfloat16" else 4))
    return 2 * (n - 1) / n * nbytes


def sharded_others(torch, dev, mesh, smi) -> None:
    """14g: recurrentgemma-2b, mamba2-1.3b and whisper-large-v3 at full
    width and depth (bf16, generator seed 0) on the (1, 1) mesh: phase
    12's prompt, ``MESH_STEPS`` greedy steps with the cache placed by
    ``cache_sharding_tree``, tokens equal to the unsharded decode."""
    import gc
    from repro_torch.configs import load_arch
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as sh
    from repro_torch.models import build_model
    for arch in OTHER_ARCHS:
        cfg = load_arch(arch)
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, dev).init(
            torch.Generator(dev).manual_seed(0))
        prompt = other_prompt(serve, cfg)
        want, plain_s = mesh_greedy(torch, model, prompt, MESH_STEPS)
        sh.distribute_params(model, mesh, cfg)
        sh.install_activation_rules(mesh, cfg)
        got, dec_s = mesh_greedy(torch, model, prompt, MESH_STEPS, mesh, cfg)
        sh.clear_activation_rules()
        if not torch.equal(got, want):
            fail(f"mesh decode {cfg.name}: tokens differ from the unsharded "
                 f"decode")
        b, p_len = np.shape(prompt["tokens"])
        frames = (f"{WHISPER_FRAMES} frames + " if cfg.is_encoder_decoder
                  else "")
        print(f"mesh decode: {cfg.name} at full width on the (1, 1) mesh: "
              f"prefill {b} x ({frames}{p_len} tokens) + {MESH_STEPS} "
              f"greedy steps in {dec_s * 1e3:.3f} ms (unsharded "
              f"{plain_s * 1e3:.3f} ms; each the second of two runs), tokens "
              f"equal to the unsharded decode; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
        del model
        gc.collect()
        torch.cuda.empty_cache()


def mesh_checkpoint(torch, dev, mesh, smi) -> None:
    """14h: at granite's 2-layer float32 cut, 2 train steps on the (1, 1)
    mesh, a checkpoint saved from it (every leaf made whole, rank 0
    writes), restored on one device (every leaf equal to the mesh's, bit
    for bit), and a third step there: losses and parameters equal to 3
    uninterrupted unsharded steps from the same weights (1e-5 of
    scale)."""
    import dataclasses
    import gc
    import tempfile
    from repro_torch.configs import load_arch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import sharding as sh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step

    cut = dataclasses.replace(load_arch(PRODUCER_ARCH), num_layers=2,
                              dtype="float32")
    data = SyntheticLMData(cut, 64, 4, seed=3)
    opt_cfg = OptConfig(warmup_steps=0, total_steps=10)
    torch.cuda.reset_peak_memory_stats(dev)

    def steps(m, opt, lo, hi, place=None):
        step = make_train_step(m, opt_cfg, microbatches=2, place_batch=place)
        losses = []
        for s in range(lo, hi):
            opt, met = step(opt, data.batch_at(s))
            loss = met["loss"]
            losses.append(float(loss.full_tensor() if hasattr(
                loss, "full_tensor") else loss))
        return opt, losses

    m = granite_built(torch, cut, dev, 1)
    _, want = steps(m, init_opt_state(m.parameters(), opt_cfg), 0, 3)
    want_p = [p.detach().cpu() for p in m.parameters()]
    del m
    m = sh.distribute_params(granite_built(torch, cut, dev, 1), mesh, cut)
    sh.install_activation_rules(mesh, cut)
    opt, got = steps(m, init_opt_state(m.parameters(), opt_cfg), 0, 2,
                     lambda b: sh.distribute_batch(mesh, b, cut))
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(tmp, 1, {"params": m, "opt": opt})
        save_ms = (time.perf_counter() - t0) * 1e3
        sh.clear_activation_rules()
        n_bytes = sum(os.path.getsize(os.path.join(tmp, "step_00000001", f))
                      for f in os.listdir(os.path.join(tmp, "step_00000001")))
        one = granite_built(torch, cut, dev, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ckpt.restore(tmp, 1, {"params": one, "opt": init_opt_state(
            one.parameters(), opt_cfg)})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    mine = ([p.detach() for p in m.parameters()] + [opt.step] + list(opt.mu)
            + list(opt.nu) + list(opt.master))
    back = state["opt"]
    theirs = ([p.detach() for p in one.parameters()] + [back.step] +
              list(back.mu) + list(back.nu) + list(back.master))
    if len(mine) != len(theirs) or not all(
            torch.equal(whole(a), b) for a, b in zip(mine, theirs)):
        fail("mesh ckpt: a leaf restored on one device differs from the "
             "mesh's")
    del m, opt, mine
    _, last = steps(one, back, 2, 3)
    got += last
    e_loss = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got, want))
    e_par = max(float((p.detach().cpu() - w).abs().max()) /
                max(1.0, float(w.abs().max()))
                for p, w in zip(one.parameters(), want_p))
    if e_loss > 1e-5 or e_par > 1e-5:
        fail(f"mesh ckpt: the resumed steps differ from the uninterrupted "
             f"ones (losses {got} vs {want}; parameters {e_par} of scale)")
    print(f"mesh ckpt: {cut.name} 2-layer float32 cut, 2 steps on the (1, "
          f"1) mesh, saved ({n_bytes / 1e9:.2f} GB in {save_ms:.3f} ms), "
          f"restored on one device ({restore_ms:.3f} ms; {len(theirs)} "
          f"leaves equal bit for bit), a third step there: losses "
          f"{', '.join(f'{x:.6f}' for x in got)} vs uninterrupted "
          f"{', '.join(f'{x:.6f}' for x in want)} (max err {e_loss:.3e}), "
          f"parameters max err {e_par:.3e} of scale (limit 1e-5); peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB ({smi})")
    del one, state, back
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_cells() -> None:
    """14a: ``python -m repro_torch.launch.dryrun`` for every cell on both
    meshes (no cost), granite_3_2b/train_4k with cost and the MaskSearch
    cells, four processes side by side: no cell may fail; cells over
    80 GB a rank are printed, as the reference records them."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory() as out:
        runs = {"single": ["--all", "--mesh", "single", "--no-cost"],
                "multi": ["--all", "--mesh", "multi", "--no-cost"],
                "granite": ["--arch", "granite_3_2b", "--shape", "train_4k",
                            "--mesh", "single"],
                "masksearch": ["--masksearch", "--mesh", "single"]}
        # the four runs side by side, each into a directory of its own
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out", os.path.join(out, k)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k, args in runs.items()}
        try:
            for k, p in procs.items():
                _, err = p.communicate(timeout=300)
                if p.returncode != 0:
                    fail(f"dryrun {' '.join(runs[k])}: exit {p.returncode}: "
                         f"{err[-2000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"dryrun: {len(runs)} runs side by side in "
              f"{time.perf_counter() - t0:.1f} s: "
              + "; ".join(" ".join(a) for a in runs.values()))
        for mesh_kind in ("single", "multi"):
            where = os.path.join(out, mesh_kind, mesh_kind)
            status = {}
            for name in sorted(os.listdir(where)):
                with open(os.path.join(where, name)) as f:
                    r = json.load(f)
                status[r["status"]] = status.get(r["status"], 0) + 1
                if r["status"] == "failed":
                    fail(f"dryrun {mesh_kind} {r['arch']}/{r['shape']}: "
                         f"{r.get('error')}")
                if r["status"] == "ok" and not r.get("fits_80g", True):
                    print(f"dryrun {mesh_kind} {r['arch']}/{r['shape']}: "
                          f"{r['memory']['peak_estimate_bytes'] / 1e9:.2f} "
                          f"GB a rank, over 80 GB (recorded, as the "
                          f"reference records it)")
            print(f"dryrun {mesh_kind}: cells by status {status}")
        where = os.path.join(out, "masksearch", "single")
        for name in sorted(os.listdir(where)):
            with open(os.path.join(where, name)) as f:
                r = json.load(f)
            if r["status"] != "ok":
                fail(f"dryrun masksearch {r['shape']}: {r.get('error')}")
        print(f"dryrun masksearch single: {len(os.listdir(where))} cells ok")
        with open(os.path.join(out, "granite", "single",
                               "granite_3_2b__train_4k.json")) as f:
            r = json.load(f)
        roof = r["roofline"]
        print(f"dryrun granite_3_2b/train_4k single: counted "
              f"{roof['hlo_flops_global']:.4e} FLOPs on 256 ranks, "
              f"{roof['hlo_flops_global'] / r['model_flops']:.3f}x 6ND; "
              f"compute {roof['compute_s'] * 1e3:.3f} ms, memory "
              f"{roof['memory_s'] * 1e3:.3f} ms, collective "
              f"{roof['collective_s'] * 1e3:.3f} ms a rank (reckoned on "
              f"the H100's constants, not measured)")



def mesh_phase14(torch, dev, ops, smi) -> dict:
    """Phase 14: the dry-run in subprocesses (14a), the MaskSearch cells on
    one card (14b), then on a (1, 1) mesh granite (14c-d), deepseek-v2
    (14e-f), the recurrent and encoder-decoder families (14g) and a
    checkpoint saved from the mesh and resumed on one device (14h).
    Returns the MaskSearch cells' kernel launches."""
    import gc
    import tempfile
    import torch.distributed as tdist
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dryrun_cells()
    launches = masksearch_mesh_cells(torch, dev, ops, smi)
    print(f"mesh launches (MaskSearch cells): {launches}")
    from repro_torch.launch.mesh import make_local_mesh
    torch.cuda.set_device(dev.index or 0)
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_local_mesh((1, 1), ("data", "model"), "cuda")
            ep_reckoned()
            for part in (sharded_granite, sharded_deepseek, sharded_others,
                         mesh_checkpoint):
                t0 = time.perf_counter()
                part(torch, dev, mesh, smi)
                print(f"mesh {part.__name__}: "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            tdist.destroy_process_group()
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


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
    del largest, stores

    # -- 5a. the mesh backend over the float store --------------------------
    mesh_phase(torch, tq, ops, "float", {"": (
        store, results, naive,
        workload_answers(tq, store, float_sqls(), provided))},
        provided, sql_set(tq), float_sqls(), smi,
        fused=(fused_positions(n), fused_specs(provided[fused_positions(n)])))

    # -- 5b. the query service over the float store -------------------------
    service_float_phase(torch, tq, ops, masks_mod, store, provided, results,
                        naive, smi)
    del store, masks, results, naive
    torch.cuda.empty_cache()

    # -- 6-7. the packed path, then its kernels -----------------------------
    kernels += packed_phase(torch, dev, N_PACKED, floor_ms, smi)
    torch.cuda.empty_cache()

    # -- 8-9. the pair operator, then its kernels ---------------------------
    kernels += pair_phase(torch, dev, N_PAIRS, floor_ms, smi)

    # -- 10. the mask producers: a model serves, harvests masks, indexes and
    # queries them ------------------------------------------------------------
    producer_phase(torch, dev, smi)

    # -- 11. training: the trainer at full width, then Scenario 1's loop ----
    training_phase(torch, dev, smi)

    # -- 12. the other producers: recurrentgemma, mamba2 and whisper at full
    # width serve, harvest masks, index and query them ----------------------
    other_phase(torch, dev, smi)

    # -- 13. the DeepSeek family: deepseek-v2 at full width serves, harvests
    # expert-utilisation masks, indexes and queries them; deepseek-v3's
    # MTP head ----------------------------------------------------------------
    deepseek_phase(torch, dev, smi)

    # -- 14. the mesh: the dry-run, the MaskSearch cells on one card, and
    # granite's sharded train step and decode --------------------------------
    mesh_phase14(torch, dev, ops, smi)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
