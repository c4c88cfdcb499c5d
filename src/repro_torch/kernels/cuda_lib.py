"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`.  Builds
happen at first use (or all at once, in parallel, through
:func:`build_all`), into ``kernels/_build/`` — listed in ``.gitignore`` —
under a name keyed on a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the library already built.

Launches go on PyTorch's current stream and return before the kernel
runs.  Temporaries a wrapper frees right after a launch (converted ROIs,
thresholds) are safe: PyTorch's caching allocator hands their memory only
to later work on the same stream, which runs after the kernel.

Nothing here runs at import time: the CPU tests import every module of the
package on machines with no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..obs.metrics import REGISTRY as _REG

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# source stem -> the kernel wrappers (kernels/ops.py names) it serves
SOURCES = {
    "cp_count": ("cp_count", "cp_count_multi"),
    "chi_build": ("chi_cell_hist",),
    "mask_agg": ("mask_agg_counts",),
    "pair_count": ("pair_counts",),
    "popcount": ("cp_count_packed", "cp_count_multi_packed",
                 "mask_agg_counts_packed", "pair_counts_packed",
                 "fused_bounds_verify"),
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel builds, counted per wrapper under the metric the JAX package uses
# for jit cache growth: eager torch never recompiles, so a build is the one
# compile event a kernel has.
_BUILDS = _REG.counter(
    "masksearch_jit_compiles_total",
    "Kernel builds per wrapper (nvcc compiles of its CUDA source)",
    ("kernel",))
for _kernels in SOURCES.values():
    for _kernel in _kernels:
        # exported at 0 until a build, as the JAX package's counter is
        _BUILDS.labels(kernel=_kernel)

# Element types the kernels take, and elements per 16-byte vector load.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC = {torch.float32: 4, torch.bfloat16: 8}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all(names=None) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: (path, ptxas_log)}``; the log is empty for a
    library that was already built.  Raises on any failed compile."""
    names = tuple(SOURCES) if names is None else tuple(names)
    out = {name: (library_path(name), "") for name in names}
    todo = [name for name in names if not out[name][0].exists()]
    if not todo:
        return out
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    try:
        for name in todo:
            path = out[name][0]
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, path)
            for kernel in SOURCES[name]:
                _BUILDS.labels(kernel=kernel).inc()
            out[name] = (path, log)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def bind(fn, argtypes) -> None:
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t: torch.Tensor, what: str, dtypes=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dtypes is not None and t.dtype not in dtypes:
        raise TypeError(f"{what} dtype {t.dtype} is not one of {dtypes}")


def int32_rows(x, device, shape, what: str = "rois") -> torch.Tensor:
    """ROI descriptors (or another small int operand, named ``what``) as a
    contiguous int32 tensor on ``device``."""
    t = torch.as_tensor(x).to(device=device, dtype=torch.int32).contiguous()
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t


def stage(parts, device):
    """Small host arrays → one pinned buffer → one non-blocking copy to
    ``device`` (a copy from pageable memory would wait for every launch
    queued before it).  Returns the flat int32 copy on the card (keep it
    referenced until the launch that reads it is queued) and each part's
    device address in it.  The buffer comes from PyTorch's caching host
    allocator, which hands it out again only after the copy has finished.
    Parts are 4- or 8-byte types; an 8-byte part goes first, so it stays
    8-byte aligned."""
    flat = [np.ascontiguousarray(a).reshape(-1).view(np.int32) for a in parts]
    sizes = [f.size for f in flat]
    buf = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
    np.concatenate(flat, out=buf.numpy())
    card = buf.to(device, non_blocking=True)
    base = card.data_ptr()
    return card, [base + 4 * int(at) for at in np.cumsum([0] + sizes[:-1])]


def to_card(arr, device) -> torch.Tensor:
    """One small host array as a tensor of its dtype and shape on
    ``device``: by :func:`stage`'s copy to a CUDA device, a plain copy to
    any other."""
    a = np.ascontiguousarray(arr)
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    card, _ = stage([a], device)
    return card.view(t.dtype).reshape(a.shape)


def in_dtype(x, dtype) -> float:
    """A threshold rounded to the mask dtype, as the exact f32 value the
    kernel compares against (bf16 and f32 values are exact in f32)."""
    return float(torch.as_tensor(x, dtype=torch.float64).to(dtype).float())


def vec_ok(t: torch.Tensor, width: int) -> int:
    """Whether every row of ``t`` starts on a 16-byte boundary."""
    v = VEC[t.dtype]
    return int(width % v == 0 and t.data_ptr() % 16 == 0)
