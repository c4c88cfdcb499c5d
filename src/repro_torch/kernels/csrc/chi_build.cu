// CHI ingest kernel: per-cell, per-bin pixel histograms of a mask batch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/chi_build.py
// _chi_kernel (chi_cell_hist_pallas).
//
// Bound: one read of every mask byte plus one write of the (B, G, G, NB)
// int32 histograms, over 3.35 TB/s on an H100 SXM.  The work per pixel is
// a binary search over the sorted edges and one shared-memory atomic.
//
// Design.  The TPU kernel turns the per-cell segment sum into a selector
// matmul because the TPU has no fast scatter.  Hopper has shared-memory
// atomics, so the kernel scatters directly.  A block owns one band of cell
// rows of one mask -- the whole mask (all G rows of cells) whenever the
// batch alone fills the card -- and keeps that band's G x NB int histogram
// per cell row in shared memory.  It zeroes it, builds the row -> cell and
// column -> cell maps and stages the edges once, streams the band's pixel
// rows, and writes each output entry once, coalesced: no memset, no global
// atomics.
//
// Streaming: each thread keeps one column chunk of 4 pixels (a 16-byte
// load) for the whole band, so the cells of its pixels come from shared
// memory once, and walks its rows one 16-byte load at a time.  Rows that
// are not 16-byte aligned (W % 4 != 0, or an unaligned base) take the same
// map over single pixels.  Each pixel is one shared-memory atomic.  Two
// designs measured no faster (benchmarks/chip_kernel_ab.py): four rows'
// loads in flight per thread (more registers, fewer resident blocks), and
// merging equal (cell, bin) keys among a thread's four pixels first, on
// smooth saliency or on binary masks.
//
// The bin of a pixel x is the number of interior edges <= x, compared in
// f32 (searchsorted(edges, x, side="right"), as build_chi_np computes it).
// For the sorted edges the wrapper requires, a branch-free binary search
// over the edges padded with +inf to 2^LOGP - 1 entries gives that count,
// clamped to NB-1 for x = +inf; NaN compares false everywhere and lands in
// bin 0, as in the plain versions.  Cell boundaries come in as row/col
// bound arrays ((i*H)//G), so a grid that does not divide H or W is served
// by the same kernel.  The prefix sums that turn histograms into the CHI
// table stay in torch (cumsum).
#include "common.cuh"

// Number of edges e[0 .. 2^LOGP - 2] that are <= x (the edges sorted).
template <int LOGP>
__device__ __forceinline__ int bin_of(const float* e, int n_edges, float x) {
  int pos = 0;
#pragma unroll
  for (int s = (1 << LOGP) >> 1; s > 0; s >>= 1)
    pos += (e[pos + s - 1] <= x) ? s : 0;
  return min(pos, n_edges);
}

// Add the four pixels of one chunk to their (cell, bin) counts.
__device__ __forceinline__ void add4(int* hist, const int* key) {
#pragma unroll
  for (int i = 0; i < 4; ++i) atomicAdd(hist + key[i], 1);
}

template <int LOGP>
__global__ void __launch_bounds__(kThreads)
chi_cell_hist_kern(const float* __restrict__ masks,
                   const float* __restrict__ edges,     // (NB-1,), sorted
                   const int* __restrict__ row_bounds,  // (G+1,)
                   const int* __restrict__ col_bounds,  // (G+1,)
                   int H, int W, int G, int NB, int band, int vec,
                   int* __restrict__ out) {  // (B, G, G, NB)
  constexpr int P = 1 << LOGP;
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const int i0 = blockIdx.y * band;          // this block's cell rows
  const int i1 = min(G, i0 + band);
  const int n_hist = (i1 - i0) * G * NB;
  int* hist = smem;                          // band * G * NB
  int* row_key = hist + band * G * NB;       // H: (cell row - i0) * G * NB
  int* col_key = row_key + H;                // W: cell col * NB
  int* bounds = col_key + W;                 // 2 (G + 1)
  float* edge = reinterpret_cast<float*>(bounds + 2 * (G + 1));  // P
  const int n_edges = NB - 1;
  for (int k = threadIdx.x; k < n_hist; k += blockDim.x) hist[k] = 0;
  for (int k = threadIdx.x; k <= G; k += blockDim.x) {
    bounds[k] = row_bounds[k];
    bounds[G + 1 + k] = col_bounds[k];
  }
  for (int k = threadIdx.x; k < P; k += blockDim.x)
    edge[k] = k < n_edges ? edges[k] : __int_as_float(0x7f800000);  // +inf
  __syncthreads();
  // Rows [rb[i0], rb[i1]) are exactly the rows whose cell row lies in
  // [i0, i1); a pixel's cell is searchsorted(bounds, p, "right") - 1,
  // clipped to [0, G-1].
  const int r0 = bounds[i0], r1 = bounds[i1];
  for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int i = -1;
    for (int q = 0; q <= G; ++q) i += (bounds[q] <= r);
    row_key[r - r0] = (min(max(i, 0), G - 1) - i0) * G * NB;
  }
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    int j = -1;
    for (int q = 0; q <= G; ++q) j += (bounds[G + 1 + q] <= c);
    col_key[c] = min(max(j, 0), G - 1) * NB;
  }
  __syncthreads();
  const float* m = masks + (size_t)b * H * W;
  if (vec) {
    const int nk = W / 4;
    const Split s = split_of(nk);
    const int rps = s.rps;
    const size_t stride = (size_t)rps * W;
    for (int k = s.active ? s.col : nk; k < nk; k += s.lpr) {
      int ck[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ck[i] = col_key[4 * k + i];
      int r = r0 + s.row;
      size_t off = (size_t)r * W + 4 * (size_t)k;
      for (; r < r1; r += rps, off += stride) {
        float v[4];
        load_vec(m + off, v);
        const int rk = row_key[r - r0];
        int key[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          key[i] = rk + ck[i] + bin_of<LOGP>(edge, n_edges, v[i]);
        add4(hist, key);
      }
    }
  } else {
    const Split s = split_of(W);
    const int rps = s.rps;
    const size_t stride = (size_t)rps * W;
    for (int c = s.active ? s.col : W; c < W; c += s.lpr) {
      const int ck = col_key[c];
      int r = r0 + s.row;
      size_t off = (size_t)r * W + c;
      for (; r < r1; r += rps, off += stride)
        atomicAdd(hist + row_key[r - r0] + ck +
                      bin_of<LOGP>(edge, n_edges, __ldg(m + off)),
                  1);
    }
  }
  __syncthreads();
  int* o = out + ((size_t)b * G + i0) * G * NB;
  for (int k = threadIdx.x; k < n_hist; k += blockDim.x) o[k] = hist[k];
}

template <int LOGP>
static int launch(const float* masks, const float* edges, const int* rb,
                  const int* cb, int B, int H, int W, int G, int NB, int band,
                  int vec, size_t smem, int* out, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chi_cell_hist_kern<LOGP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // a whole number of rows' chunks (or pixels), at most kThreads
  const int n = vec ? W / 4 : W;
  const int lpr = n < kThreads ? n : kThreads;
  const dim3 grid(B, (G + band - 1) / band);
  chi_cell_hist_kern<LOGP><<<grid, lpr * (kThreads / lpr), smem, s>>>(
      masks, edges, rb, cb, H, W, G, NB, band, vec, out);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a block, in bytes (the wrapper sizes bands with it).
extern "C" size_t chi_cell_hist_smem(int H, int W, int G, int NB, int band) {
  int logp = 0;
  while ((1 << logp) < NB) ++logp;
  return sizeof(int) * ((size_t)band * G * NB + H + W + 2 * (G + 1)) +
         sizeof(float) * ((size_t)1 << logp);
}

// Histograms of the B masks, `band` cell rows per block; vec: every row
// starts 16-byte aligned (W % 4 == 0).  NB <= 1024.
extern "C" int chi_cell_hist_launch(const void* masks, const void* edges,
                                    const void* row_bounds,
                                    const void* col_bounds, int B, int H,
                                    int W, int G, int NB, int band, int vec,
                                    void* out, void* stream) {
  const float* m = static_cast<const float*>(masks);
  const float* e = static_cast<const float*>(edges);
  const int* rb = static_cast<const int*>(row_bounds);
  const int* cb = static_cast<const int*>(col_bounds);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = chi_cell_hist_smem(H, W, G, NB, band);
  // 2^LOGP >= NB: the search covers the NB-1 edges in LOGP steps
  switch (NB <= 1 ? 0 : 32 - __builtin_clz(static_cast<unsigned>(NB - 1))) {
#define CHI_CASE(L)                                                         \
  case L:                                                                   \
    return launch<L>(m, e, rb, cb, B, H, W, G, NB, band, vec, smem, o, s);
    CHI_CASE(0) CHI_CASE(1) CHI_CASE(2) CHI_CASE(3) CHI_CASE(4) CHI_CASE(5)
    CHI_CASE(6) CHI_CASE(7) CHI_CASE(8) CHI_CASE(9) CHI_CASE(10)
#undef CHI_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
