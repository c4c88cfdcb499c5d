// CP verification kernels: count pixels with lv <= m < uv inside each
// mask's ROI.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/cp_count.py:
//   * _cp_kernel       (cp_count_pallas)       -> cp_count_kern
//   * _cp_multi_kernel (cp_count_multi_pallas) -> cp_count_multi_kern
//
// Bound: a streaming reduction with O(1) work per byte, so memory bound:
// the bytes of the ROI rows read, over 3.35 TB/s on an H100 SXM.
//
// Design.  The TPU kernel walks a sequential grid (mask, row tile) and
// carries the count across row tiles in its output block; here blocks run
// in parallel, so the grid is (mask, row strip) and each block adds its
// strip's count to the mask's output with one atomicAdd (the wrapper
// zeroes the output).  A block reads only the rows of its strip that lie
// inside the ROI, so rows outside [r0, r1) cost nothing; within a row it
// reads the 16-byte chunks overlapping [c0, c1) and masks the ragged edge.
// Per-thread counts reduce with warp shuffles and one shared-memory pass.
//
// lv/uv arrive already rounded to the mask dtype (the wrapper does it):
// f32(0.7) = 0.69999998807 is counted against lv = 0.7 by the reference,
// which compares in the mask dtype, and would not be by a double compare.
//
// The multi-descriptor kernel answers Q (roi, lv, uv) descriptors from one
// read of each strip: the strip's rows that any descriptor needs are staged
// once in shared memory (as f32), then each descriptor counts from there.
// Q is a runtime argument, so one build serves every workload size.
#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(kThreads)
cp_count_kern(const T* __restrict__ masks, const int* __restrict__ rois,
              float lv, float uv, int H, int W, int strip, int vec,
              int* __restrict__ out) {
  __shared__ int scratch[32];
  const int b = blockIdx.x;
  const int* roi = rois + 4 * (size_t)b;
  const int r0 = max(roi[0], 0), c0 = max(roi[1], 0);
  const int r1 = min(roi[2], H), c1 = min(roi[3], W);
  const int s0 = max(r0, (int)blockIdx.y * strip);
  const int s1 = min(r1, ((int)blockIdx.y + 1) * strip);
  if (s0 >= s1 || c0 >= c1) return;  // the same for every thread
  const T* m = masks + (size_t)b * H * W;
  int cnt = 0;
  if (vec) {
    constexpr int V = Elem<T>::VEC;
    const int k0 = c0 / V, nk = (c1 + V - 1) / V - k0;
    const int total = (s1 - s0) * nk;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = s0 + idx / nk;
      const int k = k0 + idx % nk;
      float v[V];
      load_vec(m + (size_t)r * W + (size_t)k * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = k * V + i;
        cnt += (c >= c0) & (c < c1) & (v[i] >= lv) & (v[i] < uv);
      }
    }
  } else {
    const int nc = c1 - c0, total = (s1 - s0) * nc;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int r = s0 + idx / nc;
      const int c = c0 + idx % nc;
      const float x = Elem<T>::to_f(m[(size_t)r * W + c]);
      cnt += (x >= lv) & (x < uv);
    }
  }
  cnt = block_sum(cnt, scratch);
  if (threadIdx.x == 0 && cnt) atomicAdd(out + b, cnt);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cp_count_multi_kern(const T* __restrict__ masks,
                    const int* __restrict__ rois,  // (Q, B, 4)
                    const float* __restrict__ lvs, const float* __restrict__ uvs,
                    int Q, int B, int H, int W, int strip, int vec,
                    int* __restrict__ out) {  // (Q, B)
  extern __shared__ float tile[];  // strip * W floats
  __shared__ int scratch[32];
  const int b = blockIdx.x;
  const int row0 = (int)blockIdx.y * strip;
  const int row1 = min(H, row0 + strip);
  // Rows of this strip that at least one descriptor needs.
  int u0 = row1, u1 = row0;
  for (int q = 0; q < Q; ++q) {
    const int* roi = rois + ((size_t)q * B + b) * 4;
    const int a0 = max(roi[0], row0), a1 = min(roi[2], row1);
    if (a0 < a1 && max(roi[1], 0) < min(roi[3], W)) {
      u0 = min(u0, a0);
      u1 = max(u1, a1);
    }
  }
  if (u0 >= u1) return;  // the same for every thread
  const T* m = masks + ((size_t)b * H + u0) * W;
  const int n = (u1 - u0) * W;
  if (vec) {
    constexpr int V = Elem<T>::VEC;
    for (int k = threadIdx.x; k < n / V; k += blockDim.x) {
      float v[V];
      load_vec(m + (size_t)k * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) tile[k * V + i] = v[i];
    }
  } else {
    for (int idx = threadIdx.x; idx < n; idx += blockDim.x)
      tile[idx] = Elem<T>::to_f(m[idx]);
  }
  __syncthreads();
  for (int q = 0; q < Q; ++q) {
    const int* roi = rois + ((size_t)q * B + b) * 4;
    const int a0 = max(roi[0], u0), a1 = min(roi[2], u1);
    const int c0 = max(roi[1], 0), c1 = min(roi[3], W);
    const float lv = lvs[q], uv = uvs[q];
    int cnt = 0;
    if (a0 < a1 && c0 < c1) {
      const int nc = c1 - c0, total = (a1 - a0) * nc;
      for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int r = a0 - u0 + idx / nc;
        const int c = c0 + idx % nc;
        const float x = tile[r * W + c];
        cnt += (x >= lv) & (x < uv);
      }
    }
    cnt = block_sum(cnt, scratch);
    if (threadIdx.x == 0 && cnt) atomicAdd(out + (size_t)q * B + b, cnt);
  }
}

extern "C" int cp_count_launch(const void* masks, int dtype, const void* rois,
                               float lv, float uv, int B, int H, int W,
                               int strip, int vec, void* out, void* stream) {
  const dim3 grid(B, (H + strip - 1) / strip);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    cp_count_kern<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(masks), static_cast<const int*>(rois), lv,
        uv, H, W, strip, vec, static_cast<int*>(out));
  } else if (dtype == DT_BF16) {
    cp_count_kern<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(masks),
        static_cast<const int*>(rois), lv, uv, H, W, strip, vec,
        static_cast<int*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cp_count_multi_launch(const void* masks, int dtype,
                                     const void* rois, const void* lvs,
                                     const void* uvs, int Q, int B, int H,
                                     int W, int strip, int vec, void* out,
                                     void* stream) {
  const dim3 grid(B, (H + strip - 1) / strip);
  const size_t smem = sizeof(float) * (size_t)strip * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    cp_count_multi_kern<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(masks), static_cast<const int*>(rois),
        static_cast<const float*>(lvs), static_cast<const float*>(uvs), Q, B,
        H, W, strip, vec, static_cast<int*>(out));
  } else if (dtype == DT_BF16) {
    cp_count_multi_kern<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(masks),
        static_cast<const int*>(rois), static_cast<const float*>(lvs),
        static_cast<const float*>(uvs), Q, B, H, W, strip, vec,
        static_cast<int*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
