// Popcount kernels over the bitpacked binary-mask tier: exact CP counts,
// Q-descriptor counts, the bounds+verify megakernel, MASK_AGG counts and
// dual-mask pair counts on 1-bit-per-pixel words.
//
// Replace the Pallas TPU kernels of src/repro/kernels/popcount.py:
//   _cp_popcount_kernel           -> cp_packed_kern       (cp_count_packed)
//   _cp_multi_popcount_kernel     -> cp_multi_block_kern  (cp_count_multi_packed)
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
// For the main path's batches both are a few microseconds.  A 224-wide
// row is 28 B, so the 32-byte sectors under a box's 3-4 words of each row
// cover nearly the whole span of its rows: the sector floor is about twice
// the word bound.
//
// Design of the single-pass kernels (cp_packed_kern, agg_packed_kern).
// One warp owns one mask (one group for MASK_AGG) and
// walks its ROI rows in a loop; it reduces with __reduce_add_sync and lane
// 0 writes each output once, so there are no atomics and no zeroing
// memset.  Only the words the ROI touches are read: its nk = ceil(c1/32) -
// floor(c0/32) words of a row are spread over min(nk, 32) lanes, and
// 32 / min(nk, 32) rows go per step (a full 224-wide row: 28 lanes, 4 rows,
// 112 contiguous bytes; a 3-word object box: 30 lanes, 10 rows).  Each lane
// keeps one word column, so it builds that column's span mask once per
// descriptor, in a register, not per row, and walks the column with four
// independent loads in flight (two rows of S loads each for MASK_AGG),
// unrolled by hand.  S is a runtime argument.
//
// Design of the Q-descriptor kernels, fused_verify_kern (the verification
// batch of a packed query, a few hundred masks) and cp_multi_block_kern
// (the scheduler's fused pass, thousands of masks): one body,
// block_counts.  A warp per mask, its descriptors one after another, each
// re-walking the rows from L1 and ending in its own reduction, left 43 of
// 132 SMs idle at 708 masks and waited on load latency.  Here a block of
// 128 threads owns one mask, read in place from the resident (N, H, nw)
// array through an optional position list (no gather).  A first pass, a
// thread per descriptor, writes the CHI-decided entries (lb; the megakernel
// only) and the empty ones (an empty ROI or lv == uv: 0) and takes the
// union of the counted descriptors' rows; a mask with nothing to count
// stops there and reads no word.  Otherwise the block copies the words of
// those rows, one contiguous range (at most 6,272 B at 224x224), into
// shared memory with 16-byte cp.async (a word-by-word copy where the plane
// is not 16-byte aligned), and its warps count the descriptors from there,
// q = warp, warp + 4, ...  Every sector is read from memory once whatever
// Q is, and each (q, b) is written once.  A plane over 48 KB is counted
// from device memory directly.  cp_multi_block_kern asks for all 16 blocks
// of an SM to be resident (32 registers, as the compiler chooses anyway);
// its thousands of masks ran 3% faster so (benchmarks/chip_kernel_ab.py).
// The wrappers stage every small host input (flags, ROIs, decided, lb,
// positions) in one pinned buffer and one copy.
//
// Design of pair_packed_kern (8,192 pairs on the naive scan).  A warp per
// pair on the box's word columns, as the single-pass kernels (two rows a
// step, four loads in flight), each mask read in place through an
// optional position list, so a device round gathers nothing.  The kernel
// waits on load latency, so it asks for 8 blocks an SM (32 registers, all
// 64 warps resident): left to the compiler, the position logic takes it
// past 32 registers and indexed calls ran 1.37x slower.  A box of 3-4 words
// a row already touches nearly every 32-byte sector of its row span (a
// 224-wide row is 28 B), so the kernel runs near the sector floor of this
// layout; a body streaming the whole row span with 16-byte loads measured
// slower (benchmarks/chip_kernel_ab.py keeps both as variants).  The lever
// left is the layout: column-major words.
//
// The CP range test on binary values is two flags computed on the host
// from float32 lv/uv (f1 = lv <= 1 < uv, f0 = lv <= 0 < uv), and the count
// is f1 * ones + f0 * (area - ones).  area is computed in closed form from
// the ROI clipped to rows [0, H) and columns [0, 32 * nw) -- equal to the
// popcount of the span masks, as in the JAX kernel, which counts the bits
// past W for a ROI that was not clipped to W.  MASK_AGG and the pair counts
// threshold with the effective word (t < 1 ? w : 0) | (t < 0 ? ~w : 0); the
// complement's tail bits are removed by the same span masks.  A pair
// counts three popcounts: ea & eb, ea | eb and ea & ~eb (|A∖B|, role A
// first).
#include "common.cuh"

constexpr int kWarps = 8;  // warps per block, one mask (or group) each
constexpr int kBlockThreads = 128;          // block_counts: a block a mask
constexpr int kStageBytes = 48 * 1024;      // largest plane staged in shared

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

// Mask b's plane: row positions[b] of the (N, H, nw) array, or row b
// without positions.  A position outside [0, N) traps, as an index out of
// range asserts.
__device__ __forceinline__ const unsigned* plane_of(
    const unsigned* __restrict__ words, const long long* __restrict__ positions,
    long long N, int b, size_t plane) {
  long long row = b;
  if (positions != nullptr) {
    row = positions[b];
    if (row < 0 || row >= N) __trap();
  }
  return words + (size_t)row * plane;
}

// A word of a plane in device memory (read-only path), or of its copy in
// shared memory.
template <bool kStaged>
__device__ __forceinline__ unsigned word_at(const unsigned* p) {
  if constexpr (kStaged) return *p;
  else return __ldg(p);
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

// Set bits under span of one word column in rows row0, row0 + step, ...
// below row1, p at the word of row0; four independent loads in flight.
template <bool kStaged>
__device__ __forceinline__ int column_ones(const unsigned* p, int nw,
                                           int row0, int row1, int step,
                                           unsigned span) {
  const size_t stride = (size_t)step * nw;
  int ones = 0, row = row0;
  for (; row + 3 * step < row1; row += 4 * step, p += 4 * stride)
    ones += __popc(word_at<kStaged>(p) & span) +
            __popc(word_at<kStaged>(p + stride) & span) +
            __popc(word_at<kStaged>(p + 2 * stride) & span) +
            __popc(word_at<kStaged>(p + 3 * stride) & span);
  for (; row < row1; row += step, p += stride)
    ones += __popc(word_at<kStaged>(p) & span);
  return ones;
}

// The shared body: one descriptor's exact CP count over one mask, valid in
// every lane.  All 32 lanes of the warp must call it.  Word (row, k) of the
// mask is m[row * nw + k - base]: the plane in device memory (base 0), or
// its rows staged in shared memory from plane word base on.
template <bool kStaged = false>
__device__ __forceinline__ int cp_desc_count(const unsigned* __restrict__ m,
                                             int H, int nw,
                                             const int* __restrict__ roi,
                                             int f1, int f0, int base = 0) {
  const Roi r = clip_roi(roi, H, nw);
  const int area = r.area();
  int ones = 0;
  if (area > 0 && (f1 | f0)) {
    const Lane g = lane_of(r);
    const int row0 = r.r0 + g.rsub;
    for (int k = g.active ? g.k : g.kend; k < g.kend; k += g.lpr)
      ones += column_ones<kStaged>(m + ((size_t)row0 * nw + k - base), nw,
                                   row0, r.r1, g.rps,
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

// 16-byte asynchronous copy from device to shared memory; both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Q descriptors over mask b = blockIdx.x, a block of kBlockThreads; with
// kDecided, entries with decided[i] set pass lb[i] through uncounted,
// without it no entry is decided (decided and lb are not read).  staged:
// the plane fits kStageBytes, so the counted rows are copied to shared
// memory once; vec: planes start on 16-byte boundaries (the array does,
// and H * nw is a multiple of 4), so the copy moves 16-byte pieces.
template <bool kDecided>
__device__ __forceinline__ void block_counts(
    const unsigned* __restrict__ words,      // (N, H, nw)
    const long long* __restrict__ positions,  // (B,) or null
    long long N,
    const int* __restrict__ flags,    // (Q, 2)
    const int* __restrict__ rois,     // (Q, B, 4)
    const int* __restrict__ decided,  // (Q, B) 0/1, kDecided only
    const int* __restrict__ lb,       // (Q, B), kDecided only
    int Q, int B, int H, int nw, int staged, int vec,
    int* __restrict__ out) {          // (Q, B)
  extern __shared__ __align__(16) unsigned stage[];
  __shared__ int rows[2];  // union [r0, r1) of the counted descriptors' rows
  const int b = blockIdx.x;
  const unsigned* m = plane_of(words, positions, N, b, (size_t)H * nw);
  if (threadIdx.x == 0) {
    rows[0] = H;
    rows[1] = 0;
  }
  __syncthreads();
  // pass 1, a thread per descriptor: decided entries pass their CHI bound
  // through, empty ones count 0, the rest widen the row union
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    const size_t i = (size_t)q * B + b;
    const Roi r = clip_roi(rois + 4 * i, H, nw);
    const bool counted = r.area() > 0 && (flags[2 * q] | flags[2 * q + 1]);
    const bool dec = kDecided && decided[i];
    if (dec) out[i] = lb[i];
    else if (!counted) out[i] = 0;
    if (counted && !dec) {
      atomicMin(&rows[0], r.r0);
      atomicMax(&rows[1], r.r1);
    }
  }
  __syncthreads();
  const int R0 = rows[0], R1 = rows[1];
  if (R0 >= R1) return;  // every entry decided or empty: no word is read
  int a0 = R0 * nw;
  if (staged) {
    int a1 = R1 * nw;
    if (vec) {  // rounded out to 16 bytes, still inside the plane
      a0 &= ~3;
      a1 = (a1 + 3) & ~3;
      for (int i = a0 + 4 * (int)threadIdx.x; i < a1; i += 4 * blockDim.x)
        cp_async16(stage + (i - a0), m + i);
      cp_async_wait_all();
    } else {
      for (int i = a0 + (int)threadIdx.x; i < a1; i += blockDim.x)
        stage[i - a0] = __ldg(m + i);
    }
    __syncthreads();
  }
  // pass 2, a warp per counted descriptor
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < Q; q += blockDim.x >> 5) {
    const size_t i = (size_t)q * B + b;
    const int f1 = flags[2 * q], f0 = flags[2 * q + 1];
    const Roi r = clip_roi(rois + 4 * i, H, nw);
    if ((kDecided && decided[i]) || r.area() <= 0 || !(f1 | f0))
      continue;  // warp-uniform
    const int c = staged ? cp_desc_count<true>(stage, H, nw, rois + 4 * i,
                                               f1, f0, a0)
                         : cp_desc_count(m, H, nw, rois + 4 * i, f1, f0);
    if (lane == 0) out[i] = c;
  }
}

__global__ void __launch_bounds__(kBlockThreads)
fused_verify_kern(const unsigned* __restrict__ words,
                  const long long* __restrict__ positions, long long N,
                  const int* __restrict__ flags, const int* __restrict__ rois,
                  const int* __restrict__ decided, const int* __restrict__ lb,
                  int Q, int B, int H, int nw, int staged, int vec,
                  int* __restrict__ out) {
  block_counts<true>(words, positions, N, flags, rois, decided, lb, Q, B, H,
                     nw, staged, vec, out);
}

__global__ void __launch_bounds__(kBlockThreads, 16)
cp_multi_block_kern(const unsigned* __restrict__ words,
                    const long long* __restrict__ positions, long long N,
                    const int* __restrict__ flags,
                    const int* __restrict__ rois, int Q, int B, int H,
                    int nw, int staged, int vec, int* __restrict__ out) {
  block_counts<false>(words, positions, N, flags, rois, nullptr, nullptr, Q,
                      B, H, nw, staged, vec, out);
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

__global__ void __launch_bounds__(kWarps * 32, 8)
pair_packed_kern(const unsigned* __restrict__ words_a,   // (Na, H, nw)
                 const long long* __restrict__ pos_a,    // (B,) or null
                 long long Na,
                 const unsigned* __restrict__ words_b,   // (Nb, H, nw)
                 const long long* __restrict__ pos_b,    // (B,) or null
                 long long Nb,
                 const int* __restrict__ rois,           // (B, 4)
                 int fa1, int fa0, int fb1, int fb0, int B, int H, int nw,
                 int* __restrict__ out) {                // (3, B)
  const int p = warp_item();
  if (p >= B) return;
  const size_t plane = (size_t)H * nw;
  const unsigned* ma = plane_of(words_a, pos_a, Na, p, plane);
  const unsigned* mb = plane_of(words_b, pos_b, Nb, p, plane);
  const Roi r = clip_roi(rois + 4 * (size_t)p, H, nw);
  const unsigned keep_a = fa1 ? 0xffffffffu : 0u;  // (ta < 1 ? w : 0)
  const unsigned flip_a = fa0 ? 0xffffffffu : 0u;  // (ta < 0 ? ~w : 0)
  const unsigned keep_b = fb1 ? 0xffffffffu : 0u;
  const unsigned flip_b = fb0 ? 0xffffffffu : 0u;
  int ci = 0, cu = 0, cd = 0;
  if (r.area() > 0) {  // lanes on the box's word columns, two rows a step
    const Lane g = lane_of(r);
    const size_t stride = (size_t)g.rps * nw;
    for (int k = g.active ? g.k : g.kend; k < g.kend; k += g.lpr) {
      const unsigned span = span_mask(r.c0, r.c1, k);
      int row = r.r0 + g.rsub;
      for (; row < r.r1; row += 2 * g.rps) {
        const bool two = row + g.rps < r.r1;
        const size_t off = (size_t)row * nw + k;
        const unsigned a0 = __ldg(ma + off), b0 = __ldg(mb + off);
        const unsigned a1 = two ? __ldg(ma + off + stride) : 0u;
        const unsigned b1 = two ? __ldg(mb + off + stride) : 0u;
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

// No work: its launch is the floor under every small call above.
__global__ void empty_kern() {}

static inline unsigned blocks_for(int items) {
  return (unsigned)((items + kWarps - 1) / kWarps);
}

// Whether a (., H, nw) array at p has every plane on a 16-byte boundary.
static inline bool planes_aligned(const void* p, int H, int nw) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (size_t)H * nw % 4 == 0;
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

// How block_counts reads a (., H, nw) array at p: rows staged in shared
// memory when a plane fits kStageBytes (smem bytes of dynamic shared
// memory), by 16-byte pieces when every plane is 16-byte aligned.
struct Staging {
  int staged, vec;
  size_t smem;
};

static inline Staging staging_of(const void* p, int H, int nw) {
  const size_t plane_bytes = (size_t)H * nw * 4;
  const int staged = plane_bytes <= (size_t)kStageBytes;
  return Staging{staged, planes_aligned(p, H, nw), staged ? plane_bytes : 0};
}

// Q descriptors over B masks, a block a mask: mask b is row positions[b] of
// the (N, H, nw) array, or row b when positions is null.  Every entry of
// out is written.
extern "C" int cp_multi_packed_launch(const void* words, const void* positions,
                                      long long N, const void* flags,
                                      const void* rois, int Q, int B, int H,
                                      int nw, void* out, void* stream) {
  const Staging st = staging_of(words, H, nw);
  cp_multi_block_kern<<<B, kBlockThreads, st.smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words),
      static_cast<const long long*>(positions), N,
      static_cast<const int*>(flags), static_cast<const int*>(rois), Q, B, H,
      nw, st.staged, st.vec, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same with CHI-decided entries, which pass lb through uncounted.
extern "C" int fused_verify_launch(const void* words, const void* positions,
                                   long long N, const void* flags,
                                   const void* rois, const void* decided,
                                   const void* lb, int Q, int B, int H,
                                   int nw, void* out, void* stream) {
  const Staging st = staging_of(words, H, nw);
  fused_verify_kern<<<B, kBlockThreads, st.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words),
      static_cast<const long long*>(positions), N,
      static_cast<const int*>(flags), static_cast<const int*>(rois),
      static_cast<const int*>(decided), static_cast<const int*>(lb), Q, B, H,
      nw, st.staged, st.vec, static_cast<int*>(out));
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

// B pairs: pair p is (row pos_a[p] of words_a, row pos_b[p] of words_b),
// each row p of its array where its positions are null.
extern "C" int pair_packed_launch(const void* words_a, const void* pos_a,
                                  long long Na, const void* words_b,
                                  const void* pos_b, long long Nb,
                                  const void* rois, int fa1, int fa0, int fb1,
                                  int fb0, int B, int H, int nw, void* out,
                                  void* stream) {
  pair_packed_kern<<<blocks_for(B), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(words_a),
      static_cast<const long long*>(pos_a), Na,
      static_cast<const unsigned*>(words_b),
      static_cast<const long long*>(pos_b), Nb, static_cast<const int*>(rois),
      fa1, fa0, fb1, fb0, B, H, nw, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_launch(void* stream) {
  empty_kern<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
