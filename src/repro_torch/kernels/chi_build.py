"""CUDA CHI ingest kernel (``csrc/chi_build.cu``) behind ctypes.

:func:`chi_cell_hist_cuda` launches ``chi_cell_hist_kern``, the port of the
Pallas ``_chi_kernel``: per-cell, per-bin pixel histograms of a mask batch,
``(B, H, W)`` f32 → ``(B, G, G, NB)`` int32.  Cell boundaries are
``(i * H) // G`` (``CHIConfig.row_bounds``), passed to the kernel as
arrays, so grids that do not divide the mask are served by the same kernel
rather than a fallback.  The prefix sums into the CHI table stay in torch
(``core.chi.histograms_to_table``).

A block holds the histograms of a band of cell rows of one mask in shared
memory: the whole mask when the batch fills the card, fewer cell rows when
it does not (or when a whole mask's histograms do not fit).  The edges and
bounds live on the card once per (device, value) — a call launches the
kernel and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import cuda_lib

_P, _I = ctypes.c_void_p, ctypes.c_int
# Shared memory a block may opt in to on sm_90 (227 KB).
_MAX_SMEM_BYTES = 232448
_MAX_BINS = 1024
# Blocks per SM the band split aims for when the batch is small.
_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("chi_build")
    cuda_lib.bind(lib.chi_cell_hist_launch,
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P])
    lib.chi_cell_hist_smem.argtypes = [_I, _I, _I, _I, _I]
    lib.chi_cell_hist_smem.restype = ctypes.c_size_t
    return lib


def cell_bounds(n: int, grid: int) -> np.ndarray:
    """``[(i * n) // grid for i in 0..grid]`` as int32."""
    return (np.arange(grid + 1, dtype=np.int64) * n // grid).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _bounds_on(device: torch.device, n: int, grid: int) -> torch.Tensor:
    return torch.from_numpy(cell_bounds(n, grid)).to(device)


@functools.lru_cache(maxsize=64)
def _edges_on(device: torch.device, values: tuple) -> torch.Tensor:
    """Interior edges as an f32 tensor on ``device``, kept per (device,
    edges): a host-to-device copy from pageable memory synchronizes the
    stream, so each ingest batch should not pay one."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def cell_rows_per_block(b: int, h: int, w: int, g: int, nb: int,
                        device) -> int:
    """The band of cell rows a block owns: all G (a block per mask) once
    the B masks alone fill the card, fewer for a small batch, and as many
    as fit in shared memory."""
    lib = _lib()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    band = math.ceil(g / min(g, math.ceil(_BLOCKS_PER_SM * sms / b)))
    while band > 1 and lib.chi_cell_hist_smem(h, w, g, nb, band) > \
            _MAX_SMEM_BYTES:
        band = math.ceil(band / 2)
    smem = lib.chi_cell_hist_smem(h, w, g, nb, band)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"chi_cell_hist needs {smem} B of shared memory "
                         f"(grid {g}, {nb} bins, {h}x{w}); max "
                         f"{_MAX_SMEM_BYTES}")
    return band


def chi_cell_hist_cuda(masks: torch.Tensor, interior_edges, grid: int):
    """(B, H, W) f32, (NB-1,) sorted → ((B, G, G, NB) int32, launches)."""
    cuda_lib.require_cuda(masks, "masks", (torch.float32,))
    b, h, w = masks.shape
    dev = masks.device
    g = int(grid)
    if not 1 <= g <= 65535:
        raise ValueError(f"chi_cell_hist grid must be in [1, 65535], got {g}")
    values = torch.as_tensor(interior_edges).reshape(-1).to(
        torch.float32).cpu().numpy()
    if np.isnan(values).any() or not np.all(values[1:] >= values[:-1]):
        raise ValueError("chi_cell_hist needs sorted interior edges without "
                         "NaN (the kernel binary-searches them)")
    nb = values.shape[0] + 1
    if nb > _MAX_BINS:
        raise ValueError(f"chi_cell_hist takes at most {_MAX_BINS} bins, "
                         f"got {nb}")
    if b == 0 or h == 0 or w == 0:
        return torch.zeros((b, g, g, nb), dtype=torch.int32, device=dev), 0
    lib = _lib()
    band = cell_rows_per_block(b, h, w, g, nb, dev)
    out = torch.empty((b, g, g, nb), dtype=torch.int32, device=dev)
    rc = lib.chi_cell_hist_launch(
        masks.data_ptr(), _edges_on(dev, tuple(values.tolist())).data_ptr(),
        _bounds_on(dev, h, g).data_ptr(), _bounds_on(dev, w, g).data_ptr(),
        b, h, w, g, nb, band, cuda_lib.vec_ok(masks, w), out.data_ptr(),
        cuda_lib.stream(dev))
    cuda_lib.check(rc, "chi_cell_hist")
    return out, 1
