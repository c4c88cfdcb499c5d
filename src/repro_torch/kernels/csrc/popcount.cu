// Popcount kernels over the bitpacked binary-mask tier: exact CP counts,
// Q-descriptor counts, the bounds+verify megakernel, MASK_AGG counts and
// dual-mask pair counts on 1-bit-per-pixel words.
//
// Replace the Pallas TPU kernels of src/repro/kernels/popcount.py:
//   _cp_popcount_kernel           -> cp_packed_kern       (cp_count_packed)
//   _cp_multi_popcount_kernel     -> cp_multi_packed_kern (cp_count_multi_packed)
//   _agg_popcount_kernel          -> agg_packed_kern      (mask_agg_counts_packed)
//   _pair_popcount_kernel         -> pair_packed_kern     (pair_counts_packed)
//   _fused_verify_popcount_kernel -> fused_verify_kern    (fused_bounds_verify)
//
// Masks are (B, H, nw) 32-bit words, bit i of word k = pixel column
// 32k + i, tail bits past W zero.  The store keeps them as uint32 and torch
// as their int32 bit view; here they are read as unsigned.
//
// Bound: one read of the words of the ROI rows (a 224x224 mask is 224 x 7
// words = 6,272 B) over 3.35 TB/s, against one popcount per word and
// counted descriptor at 16 per clock per SM (compute capability 9.0).
// For the main path's batches both are a few microseconds.
//
// Design.  One warp owns one mask (one group for MASK_AGG) and walks its
// ROI rows in a loop; it reduces with __reduce_add_sync and lane 0 writes
// each output once, so there are no atomics and no zeroing memset.  Only
// the words the ROI touches are read: its nk = ceil(c1/32) - floor(c0/32)
// words of a row are spread over min(nk, 32) lanes, and 32 / min(nk, 32)
// rows go per step (a full 224-wide row: 28 lanes, 4 rows, 112 contiguous
// bytes; a 3-word object box: 30 lanes, 10 rows).  Each lane keeps one word
// column, so it builds that column's span mask once per descriptor, in a
// register, not per row, and walks the column with four independent loads
// in flight (two rows of S loads each for MASK_AGG), unrolled by hand.  Q
// descriptors re-read the mask's rows from L1 (6 KB), so the words come
// from device memory once; Q and S are runtime arguments.
//
// The CP range test on binary values is two flags computed on the host
// from float32 lv/uv (f1 = lv <= 1 < uv, f0 = lv <= 0 < uv), and the count
// is f1 * ones + f0 * (area - ones).  area is computed in closed form from
// the ROI clipped to rows [0, H) and columns [0, 32 * nw) -- equal to the
// popcount of the span masks, as in the JAX kernel, which counts the bits
// past W for a ROI that was not clipped to W.  MASK_AGG and the pair counts
// threshold with the effective word (t < 1 ? w : 0) | (t < 0 ? ~w : 0); the
// complement's tail bits are removed by the same span masks.  A pair reads
// the same word of both masks (two loads per row step, four in flight) and
// counts three popcounts: ea & eb, ea | eb and ea & ~eb (|A∖B|, role A
// first).
#include "common.cuh"

constexpr int kWarps = 8;  // warps per block, one mask (or group) each

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Bits [0, clip(n, 0, 32)) set.  Never shifts a 32-bit value by 32.
__device__ __forceinline__ unsigned mask_lt(int n) {
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : ((1u << n) - 1u));
}

// Bits of word k inside columns [c0, c1).
__device__ __forceinline__ unsigned span_mask(int c0, int c1, int k) {
  return mask_lt(c1 - 32 * k) & ~mask_lt(c0 - 32 * k);
}

// A ROI clipped to rows [0, H) and columns [0, 32 * nw).
struct Roi {
  int r0, c0, r1, c1;
  __device__ __forceinline__ int area() const {
    return max(r1 - r0, 0) * max(c1 - c0, 0);
  }
};

__device__ __forceinline__ Roi clip_roi(const int* __restrict__ roi, int H,
                                        int nw) {
  const int w32 = 32 * nw;
  return Roi{clampi(roi[0], 0, H), clampi(roi[1], 0, w32),
             clampi(roi[2], 0, H), clampi(roi[3], 0, w32)};
}

// Which of a non-empty ROI's words and rows this lane reads: words
// k, k + lpr, ... below kend, rows r0 + rsub, r0 + rsub + rps, ...
struct Lane {
  int k, kend, lpr, rsub, rps;
  bool active;
};

__device__ __forceinline__ Lane lane_of(const Roi& r) {
  const int lane = threadIdx.x & 31;
  const int k0 = r.c0 >> 5, k1 = (r.c1 + 31) >> 5;
  Lane g;
  g.lpr = min(k1 - k0, 32);
  g.rps = 32 / g.lpr;
  g.k = k0 + lane % g.lpr;
  g.kend = k1;
  g.rsub = lane / g.lpr;
  g.active = lane < g.lpr * g.rps;
  return g;
}

// Set bits under span of the words of column k in rows row0, row0 + step,
// ... below row1 of mask m, four independent loads in flight.
__device__ __forceinline__ int column_ones(const unsigned* __restrict__ m,
                                           int nw, int k, int row0, int row1,
                                           int step, unsigned span) {
  const size_t stride = (size_t)step * nw;
  const unsigned* p = m + (size_t)row0 * nw + k;
  int ones = 0, row = row0;
  for (; row + 3 * step < row1; row += 4 * step, p += 4 * stride)
    ones += __popc(__ldg(p) & span) + __popc(__ldg(p + stride) & span) +
            __popc(__ldg(p + 2 * stride) & span) +
            __popc(__ldg(p + 3 * stride) & span);
  for (; row < row1; row += step, p += stride) ones += __popc(__ldg(p) & span);
  return ones;
}

// The shared body: one descriptor's exact CP count over one mask, valid in
// every lane.  All 32 lanes of the warp must call it.
__device__ __forceinline__ int cp_desc_count(const unsigned* __restrict__ m,
                                             int H, int nw,
                                             const int* __restrict__ roi,
                                             int f1, int f0) {
  const Roi r = clip_roi(roi, H, nw);
  const int area = r.area();
  int ones = 0;
  if (area > 0 && (f1 | f0)) {
    const Lane g = lane_of(r);
    for (int k = g.active ? g.k : g.kend; k < g.kend; k += g.lpr)
      ones += column_ones(m, nw, k, r.r0 + g.rsub, r.r1, g.rps,
                          span_mask(r.c0, r.c1, k));
  }
  ones = __reduce_add_sync(0xffffffffu, ones);
  return f1 * ones + f0 * (area - ones);
}

__device__ __forceinline__ int warp_item() {
  return blockIdx.x * kWarps + (threadIdx.x >> 5);
}

__global__ void __launch_bounds__(kWarps * 32)
cp_packed_kern(const unsigned* __restrict__ words,  // (B, H, nw)
               const int* __restrict__ rois,        // (B, 4)
               int f1, int f0, int B, int H, int nw, int* __restrict__ out) {
  const int b = warp_item();
  if (b >= B) return;  // the whole warp
  const int c = cp_desc_count(words + (size_t)b * H * nw, H, nw,
                              rois + 4 * (size_t)b, f1, f0);
  if ((threadIdx.x & 31) == 0) out[b] = c;
}

__global__ void __launch_bounds__(kWarps * 32)
cp_multi_packed_kern(const unsigned* __restrict__ words,  // (B, H, nw)
                     const int* __restrict__ rois,        // (Q, B, 4)
                     const int* __restrict__ flags,       // (Q, 2): f1, f0
                     int Q, int B, int H, int nw,
                     int* __restrict__ out) {             // (Q, B)
  const int b = warp_item();
  if (b >= B) return;
  const unsigned* m = words + (size_t)b * H * nw;
  for (int q = 0; q < Q; ++q) {
    const size_t i = (size_t)q * B + b;
    const int c = cp_desc_count(m, H, nw, rois + 4 * i, flags[2 * q],
                                flags[2 * q + 1]);
    if ((threadIdx.x & 31) == 0) out[i] = c;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
fused_verify_kern(const unsigned* __restrict__ words,  // (B, H, nw)
                  const int* __restrict__ rois,        // (Q, B, 4)
                  const int* __restrict__ flags,       // (Q, 2)
                  const int* __restrict__ decided,     // (Q, B) 0/1
                  const int* __restrict__ lb,          // (Q, B)
                  int Q, int B, int H, int nw,
                  int* __restrict__ out) {             // (Q, B)
  const int b = warp_item();
  if (b >= B) return;
  const unsigned* m = words + (size_t)b * H * nw;
  for (int q = 0; q < Q; ++q) {
    const size_t i = (size_t)q * B + b;
    if (decided[i]) {  // the CHI bound is exact: pass it through uncounted
      if ((threadIdx.x & 31) == 0) out[i] = lb[i];
      continue;
    }
    const int c = cp_desc_count(m, H, nw, rois + 4 * i, flags[2 * q],
                                flags[2 * q + 1]);
    if ((threadIdx.x & 31) == 0) out[i] = c;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
agg_packed_kern(const unsigned* __restrict__ words,  // (N, S, H, nw)
                const int* __restrict__ rois,        // (N, 4)
                int f1, int f0, int N, int S, int H, int nw,
                int* __restrict__ inter, int* __restrict__ uni) {
  const int n = warp_item();
  if (n >= N) return;
  const Roi r = clip_roi(rois + 4 * (size_t)n, H, nw);
  const size_t plane = (size_t)H * nw;
  const unsigned* grp = words + (size_t)n * S * plane;
  const unsigned keep = f1 ? 0xffffffffu : 0u;  // (t < 1 ? w : 0)
  const unsigned flip = f0 ? 0xffffffffu : 0u;  // (t < 0 ? ~w : 0)
  int ci = 0, cu = 0;
  if (r.area() > 0) {
    const Lane g = lane_of(r);
    const size_t stride = (size_t)g.rps * nw;
    for (int k = g.active ? g.k : g.kend; k < g.kend; k += g.lpr) {
      const unsigned span = span_mask(r.c0, r.c1, k);
      // two rows per step: 2 S independent loads in flight
      int row = r.r0 + g.rsub;
      for (; row < r.r1; row += 2 * g.rps) {
        const bool two = row + g.rps < r.r1;
        const unsigned* p = grp + (size_t)row * nw + k;
        unsigned all0 = 0xffffffffu, any0 = 0u;  // empty S: AND true, OR false
        unsigned all1 = 0xffffffffu, any1 = 0u;
        for (int s = 0; s < S; ++s) {
          const unsigned w0 = __ldg(p + s * plane);
          const unsigned w1 = two ? __ldg(p + s * plane + stride) : 0u;
          const unsigned e0 = (w0 & keep) | (~w0 & flip);
          const unsigned e1 = (w1 & keep) | (~w1 & flip);
          all0 &= e0;
          any0 |= e0;
          all1 &= e1;
          any1 |= e1;
        }
        ci += __popc(all0 & span) + (two ? __popc(all1 & span) : 0);
        cu += __popc(any0 & span) + (two ? __popc(any1 & span) : 0);
      }
    }
  }
  ci = __reduce_add_sync(0xffffffffu, ci);
  cu = __reduce_add_sync(0xffffffffu, cu);
  if ((threadIdx.x & 31) == 0) {
    inter[n] = ci;
    uni[n] = cu;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
pair_packed_kern(const unsigned* __restrict__ words_a,  // (B, H, nw)
                 const unsigned* __restrict__ words_b,  // (B, H, nw)
                 const int* __restrict__ rois,          // (B, 4)
                 int fa1, int fa0, int fb1, int fb0, int B, int H, int nw,
                 int* __restrict__ out) {               // (3, B)
  const int p = warp_item();
  if (p >= B) return;
  const Roi r = clip_roi(rois + 4 * (size_t)p, H, nw);
  const size_t base = (size_t)p * H * nw;
  const unsigned keep_a = fa1 ? 0xffffffffu : 0u;  // (ta < 1 ? w : 0)
  const unsigned flip_a = fa0 ? 0xffffffffu : 0u;  // (ta < 0 ? ~w : 0)
  const unsigned keep_b = fb1 ? 0xffffffffu : 0u;
  const unsigned flip_b = fb0 ? 0xffffffffu : 0u;
  int ci = 0, cu = 0, cd = 0;
  if (r.area() > 0) {
    const Lane g = lane_of(r);
    const size_t stride = (size_t)g.rps * nw;
    for (int k = g.active ? g.k : g.kend; k < g.kend; k += g.lpr) {
      const unsigned span = span_mask(r.c0, r.c1, k);
      int row = r.r0 + g.rsub;
      for (; row < r.r1; row += 2 * g.rps) {
        const bool two = row + g.rps < r.r1;
        const size_t off = base + (size_t)row * nw + k;
        const unsigned a0 = __ldg(words_a + off), b0 = __ldg(words_b + off);
        const unsigned a1 = two ? __ldg(words_a + off + stride) : 0u;
        const unsigned b1 = two ? __ldg(words_b + off + stride) : 0u;
        const unsigned s1 = two ? span : 0u;
        const unsigned ea0 = (a0 & keep_a) | (~a0 & flip_a);
        const unsigned eb0 = (b0 & keep_b) | (~b0 & flip_b);
        const unsigned ea1 = (a1 & keep_a) | (~a1 & flip_a);
        const unsigned eb1 = (b1 & keep_b) | (~b1 & flip_b);
        ci += __popc(ea0 & eb0 & span) + __popc(ea1 & eb1 & s1);
        cu += __popc((ea0 | eb0) & span) + __popc((ea1 | eb1) & s1);
        cd += __popc(ea0 & ~eb0 & span) + __popc(ea1 & ~eb1 & s1);
      }
    }
  }
  ci = __reduce_add_sync(0xffffffffu, ci);
  cu = __reduce_add_sync(0xffffffffu, cu);
  cd = __reduce_add_sync(0xffffffffu, cd);
  if ((threadIdx.x & 31) == 0) {
    out[p] = ci;
    out[(size_t)B + p] = cu;
    out[2 * (size_t)B + p] = cd;
  }
}

static inline unsigned blocks_for(int items) {
  return (unsigned)((items + kWarps - 1) / kWarps);
}

extern "C" int cp_packed_launch(const void* words, const void* rois, int f1,
                                int f0, int B, int H, int nw, void* out,
                                void* stream) {
  cp_packed_kern<<<blocks_for(B), kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<const int*>(rois), f1,
      f0, B, H, nw, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cp_multi_packed_launch(const void* words, const void* rois,
                                      const void* flags, int Q, int B, int H,
                                      int nw, void* out, void* stream) {
  cp_multi_packed_kern<<<blocks_for(B), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<const int*>(rois),
      static_cast<const int*>(flags), Q, B, H, nw, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_verify_launch(const void* words, const void* rois,
                                   const void* flags, const void* decided,
                                   const void* lb, int Q, int B, int H,
                                   int nw, void* out, void* stream) {
  fused_verify_kern<<<blocks_for(B), kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<const int*>(rois),
      static_cast<const int*>(flags), static_cast<const int*>(decided),
      static_cast<const int*>(lb), Q, B, H, nw, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int agg_packed_launch(const void* words, const void* rois, int f1,
                                 int f0, int N, int S, int H, int nw,
                                 void* inter, void* uni, void* stream) {
  agg_packed_kern<<<blocks_for(N), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words), static_cast<const int*>(rois), f1,
      f0, N, S, H, nw, static_cast<int*>(inter), static_cast<int*>(uni));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pair_packed_launch(const void* words_a, const void* words_b,
                                  const void* rois, int fa1, int fa0, int fb1,
                                  int fb0, int B, int H, int nw, void* out,
                                  void* stream) {
  pair_packed_kern<<<blocks_for(B), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words_a),
      static_cast<const unsigned*>(words_b), static_cast<const int*>(rois),
      fa1, fa0, fb1, fb0, B, H, nw, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
