"""Public kernel wrappers: one dispatch point per kernel, instrumented.

Dispatch policy: a tensor on the CPU goes to the kernel's plain PyTorch
version (:mod:`.ref`); a CUDA tensor launches the hand-written CUDA kernel
or raises — there is no fallback.  That is the whole policy: the device of
the input decides, so the CPU tests reach the same call sites the card
runs.

Each wrapper keeps a plain integer ``launches`` count that moves only when
its CUDA kernel is launched (``chip_smoke.py`` zeroes and reads these
around the main path), plus the JAX package's Prometheus instruments:
``masksearch_kernel_launches_total`` (dispatches through the wrapper),
``masksearch_kernel_dispatch_seconds`` (wall time of a dispatch — on the
card, the enqueue) and ``masksearch_jit_compiles_total`` (kernel builds,
counted in :mod:`.cuda_lib`).

These wrappers are what core/ calls — nothing else imports the kernel
modules directly.
"""

from __future__ import annotations

import time

import torch

from ..obs.metrics import REGISTRY as _REG
from . import ref
from .chi_build import chi_cell_hist_cuda
from .cp_count import cp_count_cuda, cp_count_multi_cuda
from .mask_agg import mask_agg_counts_cuda
from .pair_count import pair_counts_cuda
from .popcount import (cp_count_multi_packed_cuda, cp_count_packed_cuda,
                       fused_bounds_verify_cuda, mask_agg_counts_packed_cuda,
                       pair_counts_packed_cuda)

_KERNEL_LAUNCHES = _REG.counter(
    "masksearch_kernel_launches_total",
    "Dispatches through each public kernel wrapper", ("kernel",))
_KERNEL_SECONDS = _REG.histogram(
    "masksearch_kernel_dispatch_seconds",
    "Wall time per kernel wrapper dispatch (on a CUDA tensor: the launch "
    "enqueue; the first call also builds the kernel)", ("kernel",))


class Kernel:
    """One kernel's dispatching wrapper: ``plain`` for CPU tensors,
    ``cuda`` (returning ``(out, launches)``) for CUDA tensors."""

    def __init__(self, name: str, plain, cuda, doc: str):
        self.name = name
        self.plain = plain
        self.cuda = cuda
        self.__doc__ = doc
        self.launches = 0
        self._dispatches = _KERNEL_LAUNCHES.labels(kernel=name)
        self._seconds = _KERNEL_SECONDS.labels(kernel=name)

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            if x.device.type == "cpu":
                return self.plain(x, *args, **kwargs)
            if x.device.type != "cuda":
                raise ValueError(f"{self.name}: no kernel for device "
                                 f"{x.device}")
            out, n = self.cuda(x, *args, **kwargs)
            self.launches += n
            return out
        finally:
            self._seconds.observe(time.perf_counter() - t0)
            self._dispatches.inc()

    def __repr__(self) -> str:
        return f"<kernel {self.name}: {self.launches} launches>"


cp_count = Kernel(
    "cp_count", ref.cp_count_ref, cp_count_cuda,
    "Batched exact CP — (B,H,W), (B,4), lv, uv → (B,) int32.")
cp_count_multi = Kernel(
    "cp_count_multi", ref.cp_count_multi_ref, cp_count_multi_cuda,
    "Multi-query CP — (B,H,W), (Q,B,4), (Q,), (Q,) → (Q,B) int32; with "
    "positions (B,) over an (N,H,W) array, the batch masks[positions], read "
    "in place on the card.")
chi_cell_hist = Kernel(
    "chi_cell_hist", ref.chi_cell_hist_ref, chi_cell_hist_cuda,
    "CHI ingest histograms — (B,H,W), (NB-1,), grid → (B,G,G,NB) int32.")
mask_agg_counts = Kernel(
    "mask_agg_counts", ref.mask_agg_counts_ref, mask_agg_counts_cuda,
    "Fused MASK_AGG counts — (N,S,H,W), (N,4), t → (inter, union) int32.")
pair_counts = Kernel(
    "pair_counts", ref.pair_counts_ref, pair_counts_cuda,
    "Dual-mask pair counts — (B,H,W) x 2, (B,4), ta, tb → (inter, union, "
    "diff = |A∖B|) int32, one pass over both masks.")


# -- bitpacked binary-mask tier: (…, H, words) int32 bit views of the
# store's uint32 words; lv/uv/t become float32 flags as in the JAX wrappers

cp_count_packed = Kernel(
    "cp_count_packed", ref.cp_count_packed_ref, cp_count_packed_cuda,
    "Batched exact CP on packed words — (B,H,words) int32, (B,4), lv, uv "
    "→ (B,) int32, equal to cp_count on the same binary masks.")
cp_count_multi_packed = Kernel(
    "cp_count_multi_packed", ref.cp_count_multi_packed_ref,
    cp_count_multi_packed_cuda,
    "Multi-query CP on packed words — (B,H,words), (Q,B,4), (Q,), (Q,) → "
    "(Q,B) int32.")
mask_agg_counts_packed = Kernel(
    "mask_agg_counts_packed", ref.mask_agg_counts_packed_ref,
    mask_agg_counts_packed_cuda,
    "Fused MASK_AGG counts on packed words — (N,S,H,words), (N,4), t → "
    "(inter, union) int32.")
pair_counts_packed = Kernel(
    "pair_counts_packed", ref.pair_counts_packed_ref, pair_counts_packed_cuda,
    "Dual-mask pair counts on packed words — (B,H,words) x 2, (B,4), ta, tb "
    "→ (inter, union, diff) int32, equal to pair_counts on the same binary "
    "masks.")
fused_bounds_verify = Kernel(
    "fused_bounds_verify", ref.fused_bounds_verify_ref,
    fused_bounds_verify_cuda,
    "Bounds+verify megakernel — (B,H,words), (Q,B,4), (Q,), (Q,), decided "
    "(Q,B), lb (Q,B) → (Q,B) int32: decided entries pass lb through, the "
    "rest are counted.  One launch per verification batch.")

KERNELS = (cp_count, cp_count_multi, chi_cell_hist, mask_agg_counts,
           pair_counts, cp_count_packed, cp_count_multi_packed,
           mask_agg_counts_packed, pair_counts_packed, fused_bounds_verify)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}

