"""CUDA CHI ingest kernel (``csrc/chi_build.cu``) behind ctypes.

:func:`chi_cell_hist_cuda` launches ``chi_cell_hist_kern``, the port of the
Pallas ``_chi_kernel``: per-cell, per-bin pixel histograms of a mask batch,
``(B, H, W)`` f32 → ``(B, G, G, NB)`` int32.  Cell boundaries are
``(i * H) // G`` (``CHIConfig.row_bounds``), passed to the kernel as
arrays, so grids that do not divide the mask are served by the same kernel
rather than a fallback.  The prefix sums into the CHI table stay in torch
(``core.chi.histograms_to_table``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_lib

_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_SMEM_BYTES = 48 * 1024


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_lib.library("chi_build")
    cuda_lib.bind(lib.chi_cell_hist_launch,
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P])
    return lib


def cell_bounds(n: int, grid: int, device) -> torch.Tensor:
    """``[(i * n) // grid for i in 0..grid]`` as int32, made on ``device``
    (no host-to-device copy, so no synchronization)."""
    i = torch.arange(grid + 1, dtype=torch.int64, device=device)
    return (i * n // grid).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _edges_on(device: torch.device, values: tuple) -> torch.Tensor:
    """Interior edges as an f32 tensor on ``device``, kept per (device,
    edges): a host-to-device copy from pageable memory synchronizes the
    stream, so each ingest batch should not pay one."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def chi_cell_hist_cuda(masks: torch.Tensor, interior_edges, grid: int):
    """(B, H, W) f32, (NB-1,) → ((B, G, G, NB) int32, launches)."""
    cuda_lib.require_cuda(masks, "masks", (torch.float32,))
    b, h, w = masks.shape
    dev = masks.device
    g = int(grid)
    if not 1 <= g <= 65535:
        raise ValueError(f"chi_cell_hist grid must be in [1, 65535], got {g}")
    edges = torch.as_tensor(interior_edges).reshape(-1)
    if edges.device == dev:
        edges = edges.to(torch.float32).contiguous()
    else:
        edges = _edges_on(dev, tuple(edges.to(torch.float32).tolist()))
    nb = edges.shape[0] + 1
    smem = 4 * (g * nb + w + nb - 1)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(f"chi_cell_hist needs {smem} B of shared memory "
                         f"(grid {g}, {nb} bins, width {w}); max "
                         f"{_MAX_SMEM_BYTES}")
    out = torch.zeros((b, g, g, nb), dtype=torch.int32, device=dev)
    if b == 0 or h == 0 or w == 0:
        return out, 0
    rb = cell_bounds(h, g, dev)
    cb = cell_bounds(w, g, dev)
    rc = _lib().chi_cell_hist_launch(
        masks.data_ptr(), edges.data_ptr(), rb.data_ptr(), cb.data_ptr(),
        b, h, w, g, nb, out.data_ptr(), cuda_lib.stream(dev))
    cuda_lib.check(rc, "chi_cell_hist")
    return out, 1
