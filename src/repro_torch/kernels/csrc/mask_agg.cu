// MASK_AGG kernel: thresholded intersection / union counts of each group's
// member masks inside the group's ROI (the fused primitive behind IoU
// queries).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mask_agg.py _agg_kernel
// (mask_agg_counts_pallas).
//
// Bound: one read of the ROI rows of all S member masks, over 3.35 TB/s on
// an H100 SXM; the per-pixel work is S compares.
//
// Design.  As for cp_count, the grid is (group, row strip) and each block
// adds its strip's two counts with one atomicAdd each (the wrapper zeroes
// the outputs).  For each pixel chunk the block loads the same 16 bytes of
// all S members, thresholds them with m > t (t already rounded to the mask
// dtype), and folds AND / OR in registers, so the binary masks never touch
// device memory.  An empty member set gives AND = true, OR = false, as
// jnp.all / jnp.any over an empty axis do.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_agg_kern(const T* __restrict__ masks,  // (N, S, H, W)
              const int* __restrict__ rois, float t, int S, int H, int W,
              int strip, int vec, int* __restrict__ inter,
              int* __restrict__ uni) {
  __shared__ int scratch[32];
  const int g = blockIdx.x;
  const int* roi = rois + 4 * (size_t)g;
  const int r0 = max(roi[0], 0), c0 = max(roi[1], 0);
  const int r1 = min(roi[2], H), c1 = min(roi[3], W);
  const int s0 = max(r0, (int)blockIdx.y * strip);
  const int s1 = min(r1, ((int)blockIdx.y + 1) * strip);
  if (s0 >= s1 || c0 >= c1) return;  // the same for every thread
  const size_t plane = (size_t)H * W;
  const T* grp = masks + (size_t)g * S * plane;
  int ci = 0, cu = 0;
  if (vec) {
    constexpr int V = Elem<T>::VEC;
    const int k0 = c0 / V, nk = (c1 + V - 1) / V - k0;
    const int total = (s1 - s0) * nk;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = s0 + idx / nk;
      const int k = k0 + idx % nk;
      const size_t off = (size_t)r * W + (size_t)k * V;
      bool all[V], any[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        all[i] = true;
        any[i] = false;
      }
      for (int s = 0; s < S; ++s) {
        float v[V];
        load_vec(grp + s * plane + off, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const bool hit = v[i] > t;
          all[i] = all[i] && hit;
          any[i] = any[i] || hit;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = k * V + i;
        const bool in = (c >= c0) && (c < c1);
        ci += in && all[i];
        cu += in && any[i];
      }
    }
  } else {
    const int nc = c1 - c0, total = (s1 - s0) * nc;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const size_t off = (size_t)(s0 + idx / nc) * W + (c0 + idx % nc);
      bool all = true, any = false;
      for (int s = 0; s < S; ++s) {
        const bool hit = Elem<T>::to_f(grp[s * plane + off]) > t;
        all = all && hit;
        any = any || hit;
      }
      ci += all;
      cu += any;
    }
  }
  ci = block_sum(ci, scratch);
  cu = block_sum(cu, scratch);
  if (threadIdx.x == 0) {
    if (ci) atomicAdd(inter + g, ci);
    if (cu) atomicAdd(uni + g, cu);
  }
}

extern "C" int mask_agg_launch(const void* masks, int dtype, const void* rois,
                               float t, int N, int S, int H, int W, int strip,
                               int vec, void* inter, void* uni,
                               void* stream) {
  const dim3 grid(N, (H + strip - 1) / strip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    mask_agg_kern<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(masks), static_cast<const int*>(rois), t, S,
        H, W, strip, vec, static_cast<int*>(inter), static_cast<int*>(uni));
  } else if (dtype == DT_BF16) {
    mask_agg_kern<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(masks), static_cast<const int*>(rois),
        t, S, H, W, strip, vec, static_cast<int*>(inter),
        static_cast<int*>(uni));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
