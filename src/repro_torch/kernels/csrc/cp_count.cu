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
// Design of cp_count_kern.  The TPU kernel walks a sequential grid (mask,
// row tile) and carries the count across row tiles in its output block;
// here blocks run in parallel, so the grid is (mask, row strip) and each
// block adds its strip's count to the mask's output with one atomicAdd (the
// wrapper zeroes the output).  A block reads only the rows of its strip
// that lie inside the ROI, so rows outside [r0, r1) cost nothing; within a
// row it reads the 16-byte chunks overlapping [c0, c1) and masks the ragged
// edge.  Per-thread counts reduce with warp shuffles and one shared-memory
// pass.
//
// lv/uv arrive already rounded to the mask dtype (the wrapper does it):
// f32(0.7) = 0.69999998807 is counted against lv = 0.7 by the reference,
// which compares in the mask dtype, and would not be by a double compare.
//
// Design of cp_count_multi_kern (Q descriptors, one read).  One block owns
// one mask -- read in place from the resident (N, H, W) array through an
// optional position list, so the caller gathers nothing -- and answers the
// descriptors in groups of QB (1, 2, 4 or 8 by template; larger Q loops
// over groups, re-reading from L1/L2).  A group's ROIs and thresholds go to
// shared memory once; the block streams the union box of the group's ROIs
// with 16-byte loads of the box's own chunks (an element path for rows not
// 16-byte aligned), each pixel loaded once into registers and tested
// against every descriptor of the group through a per-chunk in-ROI element
// mask, with QB counters in registers.  Each counter is reduced once and
// each (q, b) written once: no memset, no atomics.  A small batch keeps a
// block per mask too: splitting a mask's rows over four blocks (into a
// zeroed output) measured slower at 170 masks
// (benchmarks/chip_kernel_ab.py).
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


// One descriptor of a group: its ROI clipped to the mask (all 0 if empty)
// and its thresholds.
struct Desc {
  int r0, c0, r1, c1;
  float lv, uv;
};

template <int V, int QB>
__device__ __forceinline__ void tally(const float* v, int r,
                                      const unsigned* colm, const Desc* d,
                                      int* cnt) {
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const unsigned in = (r >= d[q].r0 && r < d[q].r1) ? colm[q] : 0u;
#pragma unroll
    for (int i = 0; i < V; ++i)
      cnt[q] += ((in >> i) & 1) & (v[i] >= d[q].lv) & (v[i] < d[q].uv);
  }
}

template <typename T, int QB>
__global__ void __launch_bounds__(kThreads)
cp_count_multi_kern(const T* __restrict__ masks,
                    const long long* __restrict__ positions,  // (B,) or null
                    long long N, const int* __restrict__ rois,  // (Q, B, 4)
                    const float* __restrict__ thr,  // (Q, 2): lv, uv
                    int Q, int B, int H, int W, int vec,
                    int* __restrict__ out) {  // (Q, B)
  constexpr int V = Elem<T>::VEC;
  constexpr int U = QB <= 2 ? 4 : 2;  // rows (independent loads) per step
  __shared__ Desc sdesc[QB];
  __shared__ int partial[kThreads / 32][QB];
  const int b = blockIdx.x;
  long long row = b;
  if (positions != nullptr) {
    row = positions[b];
    if (row < 0 || row >= N) __trap();  // as an out-of-range index asserts
  }
  const T* m = masks + (size_t)row * H * W;
  for (int g0 = 0; g0 < Q; g0 += QB) {
    if (threadIdx.x < QB) {
      const int q = g0 + threadIdx.x;
      Desc e = {0, 0, 0, 0, 0.f, 0.f};
      if (q < Q) {
        const int* roi = rois + ((size_t)q * B + b) * 4;
        e.r0 = max(roi[0], 0);
        e.c0 = max(roi[1], 0);
        e.r1 = min(roi[2], H);
        e.c1 = min(roi[3], W);
        if (e.r0 >= e.r1 || e.c0 >= e.c1) e.r0 = e.c0 = e.r1 = e.c1 = 0;
        e.lv = thr[2 * q];
        e.uv = thr[2 * q + 1];
      }
      sdesc[threadIdx.x] = e;
    }
    __syncthreads();
    Desc d[QB];
    int ur0 = H, uc0 = W, ur1 = 0, uc1 = 0;  // the group's union box
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      d[q] = sdesc[q];
      if (d[q].r0 < d[q].r1) {
        ur0 = min(ur0, d[q].r0);
        ur1 = max(ur1, d[q].r1);
        uc0 = min(uc0, d[q].c0);
        uc1 = max(uc1, d[q].c1);
      }
    }
    int cnt[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) cnt[q] = 0;
    if (ur0 < ur1 && vec) {  // the conditions are the same block-wide
      const int k0 = uc0 / V, k1 = (uc1 + V - 1) / V;
      const Split s = split_of(k1 - k0);
      const size_t stride = (size_t)s.rps * W;
      for (int k = s.active ? k0 + s.col : k1; k < k1; k += s.lpr) {
        unsigned colm[QB];  // which of the chunk's elements each ROI holds
#pragma unroll
        for (int q = 0; q < QB; ++q) {
          colm[q] = 0;
#pragma unroll
          for (int i = 0; i < V; ++i)
            colm[q] |= (unsigned)(k * V + i >= d[q].c0 &&
                                  k * V + i < d[q].c1) << i;
        }
        int r = ur0 + s.row;
        size_t off = (size_t)r * W + (size_t)k * V;
        for (; r + (U - 1) * s.rps < ur1; r += U * s.rps, off += U * stride) {
          float v[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u) load_vec(m + off + u * stride, v[u]);
#pragma unroll
          for (int u = 0; u < U; ++u)
            tally<V, QB>(v[u], r + u * s.rps, colm, d, cnt);
        }
        for (; r < ur1; r += s.rps, off += stride) {
          float v[V];
          load_vec(m + off, v);
          tally<V, QB>(v, r, colm, d, cnt);
        }
      }
    } else if (ur0 < ur1) {
      const Split s = split_of(uc1 - uc0);
      const size_t stride = (size_t)s.rps * W;
      for (int c = s.active ? uc0 + s.col : uc1; c < uc1; c += s.lpr) {
        unsigned colm[QB];
#pragma unroll
        for (int q = 0; q < QB; ++q)
          colm[q] = c >= d[q].c0 && c < d[q].c1;
        int r = ur0 + s.row;
        size_t off = (size_t)r * W + c;
        for (; r + (U - 1) * s.rps < ur1; r += U * s.rps, off += U * stride) {
          float v[U];
#pragma unroll
          for (int u = 0; u < U; ++u) v[u] = Elem<T>::to_f(m[off + u * stride]);
#pragma unroll
          for (int u = 0; u < U; ++u)
            tally<1, QB>(v + u, r + u * s.rps, colm, d, cnt);
        }
        for (; r < ur1; r += s.rps, off += stride) {
          const float v = Elem<T>::to_f(m[off]);
          tally<1, QB>(&v, r, colm, d, cnt);
        }
      }
    }
    // one reduction per counter: warp shuffles, then one shared pass
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int v = warp_sum(cnt[q]);
      if (lane == 0) partial[warp][q] = v;
    }
    __syncthreads();
    if (threadIdx.x < QB && g0 + (int)threadIdx.x < Q) {
      int sum = 0;
      for (int w = 0; w < ((int)blockDim.x + 31) / 32; ++w)
        sum += partial[w][threadIdx.x];
      out[(size_t)(g0 + threadIdx.x) * B + b] = sum;
    }
    // sdesc and partial are rewritten only after the next group's barrier,
    // which every reader above reaches first
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

template <typename T>
static void launch_multi(const void* masks, const void* positions,
                         long long N, const void* rois, const void* thr,
                         int Q, int B, int H, int W, int vec, void* out,
                         cudaStream_t s) {
  const dim3 grid(B, 1);
  const T* m = static_cast<const T*>(masks);
  const long long* p = static_cast<const long long*>(positions);
  const int* r = static_cast<const int*>(rois);
  const float* t = static_cast<const float*>(thr);
  int* o = static_cast<int*>(out);
  if (Q <= 1) {
    cp_count_multi_kern<T, 1><<<grid, kThreads, 0, s>>>(
        m, p, N, r, t, Q, B, H, W, vec, o);
  } else if (Q <= 2) {
    cp_count_multi_kern<T, 2><<<grid, kThreads, 0, s>>>(
        m, p, N, r, t, Q, B, H, W, vec, o);
  } else if (Q <= 4) {
    cp_count_multi_kern<T, 4><<<grid, kThreads, 0, s>>>(
        m, p, N, r, t, Q, B, H, W, vec, o);
  } else {
    cp_count_multi_kern<T, 8><<<grid, kThreads, 0, s>>>(
        m, p, N, r, t, Q, B, H, W, vec, o);
  }
}

// Q descriptors over B masks: mask b is row positions[b] of the (N, H, W)
// array, or row b when positions is null.  thr holds (lv, uv) per
// descriptor, already in the mask dtype.  Every entry of out is written.
extern "C" int cp_count_multi_launch(const void* masks, int dtype,
                                     const void* positions, long long N,
                                     const void* rois, const void* thr, int Q,
                                     int B, int H, int W, int vec, void* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    launch_multi<float>(masks, positions, N, rois, thr, Q, B, H, W, vec, out,
                        s);
  } else if (dtype == DT_BF16) {
    launch_multi<__nv_bfloat16>(masks, positions, N, rois, thr, Q, B, H, W,
                                vec, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
