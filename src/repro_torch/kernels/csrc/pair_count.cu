// Dual-mask pair counts: threshold mask A at ta and mask B at tb and count,
// inside the pair's ROI, the pixels of A∩B, A∪B and A∖B (the verification
// primitive behind IoU and saliency-vs-attention discrepancy queries).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pair_count.py
// _pair_kernel (pair_counts_pallas).
//
// Bound: one read of the ROI rows of both masks (2 x ROI pixels x itemsize)
// over 3.35 TB/s on an H100 SXM; the per-pixel work is two compares and
// three adds.
//
// Design.  The TPU kernel walks a sequential grid (pair, row tile) and
// carries its three sums in the output blocks.  Here one block owns one
// pair: it reads only the ROI's rows of both masks, each thread keeps three
// counters in registers, one block reduction ends it and thread 0 writes
// each output once -- no zeroing memset, no atomics.  Threads map to
// (row, column chunk): the ROI's nk 16-byte chunks of a row are spread over
// min(nk, 256) threads and 256 / min(nk, 256) rows go per step, so a
// thread keeps one column chunk, builds its in-ROI element mask once, and
// walks its rows two at a time (four independent 16-byte loads in flight).
// Rows that are not 16-byte aligned take the same mapping over single
// elements.
//
// ta / tb arrive already rounded to the mask dtype (the wrapper does it),
// so the f32 compare here is the compare in the mask dtype: a bf16 pixel of
// 0.80078125 is not above ta = 0.8, whose bf16 value is 0.80078125.
#include "common.cuh"

struct Counts {
  int inter = 0, uni = 0, diff = 0;
  __device__ __forceinline__ void add(int ha, int hb) {
    inter += ha & hb;
    uni += ha | hb;
    diff += ha & (hb ^ 1);
  }
};

template <int V>
__device__ __forceinline__ void tally(const float* va, const float* vb,
                                      float ta, float tb, unsigned in,
                                      Counts& c) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int m = (in >> i) & 1;
    c.add(m & (va[i] > ta), m & (vb[i] > tb));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pair_count_kern(const T* __restrict__ masks_a, const T* __restrict__ masks_b,
                const int* __restrict__ rois, float ta, float tb, int B, int H,
                int W, int vec, int* __restrict__ out) {  // out: (3, B)
  __shared__ int scratch[32];
  const int p = blockIdx.x;
  const int* roi = rois + 4 * (size_t)p;
  const int r0 = max(roi[0], 0), c0 = max(roi[1], 0);
  const int r1 = min(roi[2], H), c1 = min(roi[3], W);
  const size_t plane = (size_t)H * W;
  const T* ma = masks_a + (size_t)p * plane;
  const T* mb = masks_b + (size_t)p * plane;
  Counts c;
  if (r0 < r1 && c0 < c1 && vec) {  // the condition is the same block-wide
    constexpr int V = Elem<T>::VEC;
    const int k0 = c0 / V, k1 = (c1 + V - 1) / V;
    const Split s = split_of(k1 - k0);
    const size_t stride = (size_t)s.rps * W;
    for (int k = s.active ? k0 + s.col : k1; k < k1; k += s.lpr) {
      unsigned in = 0;  // which of the chunk's elements lie in [c0, c1)
#pragma unroll
      for (int i = 0; i < V; ++i)
        in |= (unsigned)(k * V + i >= c0 && k * V + i < c1) << i;
      int r = r0 + s.row;
      size_t off = (size_t)r * W + (size_t)k * V;
      for (; r + s.rps < r1; r += 2 * s.rps, off += 2 * stride) {
        float a0[V], b0[V], a1[V], b1[V];
        load_vec(ma + off, a0);
        load_vec(mb + off, b0);
        load_vec(ma + off + stride, a1);
        load_vec(mb + off + stride, b1);
        tally<V>(a0, b0, ta, tb, in, c);
        tally<V>(a1, b1, ta, tb, in, c);
      }
      if (r < r1) {
        float a0[V], b0[V];
        load_vec(ma + off, a0);
        load_vec(mb + off, b0);
        tally<V>(a0, b0, ta, tb, in, c);
      }
    }
  } else if (r0 < r1 && c0 < c1) {
    const Split s = split_of(c1 - c0);
    for (int col = s.active ? c0 + s.col : c1; col < c1; col += s.lpr) {
      for (int r = r0 + s.row; r < r1; r += s.rps) {
        const size_t off = (size_t)r * W + col;
        c.add(Elem<T>::to_f(ma[off]) > ta, Elem<T>::to_f(mb[off]) > tb);
      }
    }
  }
  const int ci = block_sum(c.inter, scratch);
  const int cu = block_sum(c.uni, scratch);
  const int cd = block_sum(c.diff, scratch);
  if (threadIdx.x == 0) {
    out[p] = ci;
    out[(size_t)B + p] = cu;
    out[2 * (size_t)B + p] = cd;
  }
}

extern "C" int pair_count_launch(const void* masks_a, const void* masks_b,
                                 int dtype, const void* rois, float ta,
                                 float tb, int B, int H, int W, int vec,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) {
    pair_count_kern<float><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(masks_a), static_cast<const float*>(masks_b),
        static_cast<const int*>(rois), ta, tb, B, H, W, vec,
        static_cast<int*>(out));
  } else if (dtype == DT_BF16) {
    pair_count_kern<__nv_bfloat16><<<B, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(masks_a),
        static_cast<const __nv_bfloat16*>(masks_b),
        static_cast<const int*>(rois), ta, tb, B, H, W, vec,
        static_cast<int*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
