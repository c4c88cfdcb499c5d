#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py      # 16,384 float32 masks of 224x224

Phases, each of which raises on failure (non-zero exit, no result line):

1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
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
   ROI, lv == uv, pixels on bin edges, a ragged CHI grid, bf16 masks), with
   tolerance 0 (every output is an integer count), and time it beside the
   plain version and the card's bound;
5. run a 64-mask store through the same queries on the card and on the
   CPU (plain kernel versions) and require identical answers.

Kernel launch counters are zeroed just before the main path (phases 2-3,
indexed queries only) and read just after it; every kernel must have been
launched there.  The script prints the build, the card, per-query times
and stats, a ``{"kernels": [...]}`` line and, last, the result line
``{"ok": true, "device": {...}}``.  It needs a CUDA device and the
repository's ``src/`` beside it; without either it exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

N_MASKS = 16384
H = W = 224
CHUNK = 2048
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores

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
        b, h, w = x.shape
        rois = torch.as_tensor(args[1]).to(x.device, torch.int32)
        union = torch.zeros((b, h, w), dtype=torch.bool, device=x.device)
        for q in range(rois.shape[0]):
            union |= ref._roi_mask(rois[q], h, w)
        px = int(union.sum())
        q = rois.shape[0]
        nbytes = px * isz + q * b * 16 + q * 8 + q * b * 4
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
    torch.cuda.synchronize()
    return n_cases


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
    from repro_torch.kernels import cuda_lib, ops, ref

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

    # -- data (set-up, not timed as ingest) ---------------------------------
    t0 = time.perf_counter()
    masks, rois = make_data(n, H, W, masks_mod)
    meta = make_meta(n, MASK_META_DTYPE)
    print(f"data: {n} masks {H}x{W} float32 "
          f"({masks.nbytes / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s")
    cfg = CHIConfig(grid=16, num_bins=16, height=H, width=W)

    # record each kernel's largest main-path call, for the parity phase
    largest: dict = {}
    launchers = {k.name: k.cuda for k in ops.KERNELS}

    def recording(kernel):
        launch = launchers[kernel.name]

        def rec(*a):
            size = a[0].numel()
            if size >= largest.get(kernel.name, (-1, None))[0]:
                largest[kernel.name] = (size, a)
            return launch(*a)
        kernel.cuda = rec

    for k in ops.KERNELS:
        recording(k)

    # -- 2-3. the main path: ingest + indexed queries -----------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    store = MaskStore.create_memory(masks[:CHUNK], meta[:CHUNK], cfg,
                                    device=dev)
    t_create = time.perf_counter() - t0
    t_app = []
    for s in range(CHUNK, n, CHUNK):
        t1 = time.perf_counter()
        store.append(masks[s:s + CHUNK], meta[s:s + CHUNK])
        torch.cuda.synchronize()
        t_app.append(time.perf_counter() - t1)
    ingest_s = time.perf_counter() - t0
    ingest_launch = ops.launch_counts()
    print(f"ingest: create_memory({CHUNK}) {t_create:.3f} s, "
          f"{len(t_app)} x append({CHUNK}) {sum(t_app):.3f} s "
          f"(each {', '.join(f'{t:.3f}' for t in t_app)}), "
          f"total {ingest_s:.3f} s; chi_cell_hist launches "
          f"{ingest_launch['chi_cell_hist']}")

    provided = rois[meta["mask_id"]]
    results: dict = {}
    for qname, sql in sql_set(tq):
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
            results[(qname, be)] = (res, stats)
            n_out = len(res[0]) if isinstance(res, tuple) else len(res)
            print(f"query {qname} backend={be}: {wall:.3f} s, {n_out} ids, "
                  + json.dumps({f: getattr(stats, f) for f in STAT_FIELDS
                                + ("bytes_loaded", "chi_bytes")})
                  + f", launches {json.dumps(launches)}")
    main_launches = ops.launch_counts()
    for k in ops.KERNELS:
        k.cuda = launchers[k.name]
    for k, c in main_launches.items():
        if c <= 0:
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
    for qname, sql in sql_set(tq):
        (rd, sd), (rh, sh) = results[(qname, "device")], results[(qname, "host")]
        if not same_answer(rd, rh):
            fail(f"{qname}: device and host answers differ")
        for f in STAT_FIELDS:
            if getattr(sd, f) != getattr(sh, f):
                fail(f"{qname}: {f} differs (device {getattr(sd, f)}, "
                     f"host {getattr(sh, f)})")
        if isinstance(rd, tuple) and not np.all(np.isfinite(rd[1])):
            fail(f"{qname}: non-finite scores")
        t1 = time.perf_counter()
        rn, sn = tq.run(sql, store, provided_rois=provided, use_index=False)
        torch.cuda.synchronize()
        if not same_answer(rd, rn):
            fail(f"{qname}: indexed answer differs from the naive scan")
        print(f"check {qname}: device == host == naive scan "
              f"({sn.n_verified} masks scanned in "
              f"{time.perf_counter() - t1:.3f} s)")

    # -- 4. kernels against their plain versions ----------------------------
    n_edge = edge_cases(torch, ops, ref)
    plain = {"cp_count": ref.cp_count_ref,
             "cp_count_multi": ref.cp_count_multi_ref,
             "chi_cell_hist": ref.chi_cell_hist_ref,
             "mask_agg_counts": ref.mask_agg_counts_ref}
    kernels = []
    for k in ops.KERNELS:
        _, a = largest[k.name]
        got = k(*a)
        want = plain[k.name](*a)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        if err != 0:
            fail(f"{k.name} differs from its plain version at main-path "
                 f"shape {tuple(a[0].shape)} (max abs err {err})")
        ms = time_ms(torch, lambda k=k, a=a: k(*a))
        plain_ms = time_ms(torch, lambda f=plain[k.name], a=a: f(*a), reps=3,
                           warmup=1)
        bound_ms, bound_by = bound_of(torch, ref, k.name, a)
        src, replaces = KERNEL_INFO[k.name]
        print(f"parity {k.name}: main-path shape {tuple(a[0].shape)} "
              f"{str(a[0].dtype).replace('torch.', '')} equal, "
              f"{n_edge[k.name]} edge cases equal; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), library none")
        kernels.append({"name": k.name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": int(main_launches[k.name]),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})

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
    for qname, sql in sql_set(tq):
        want, _ = tq.run(sql, stores["cpu"], provided_rois=sm_rois,
                         backend="host")
        for be in ("device", "host"):
            got, _ = tq.run(sql, stores["cuda"], provided_rois=sm_rois,
                            backend=be)
            if not same_answer(got, want):
                fail(f"small store {qname} on {be}: card differs from CPU")
    print("small store: 64 masks 64x64, four queries identical on the card "
          "(device and host backends) and on the CPU")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
