// CHI ingest kernel: per-cell, per-bin pixel histograms of a mask batch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/chi_build.py
// _chi_kernel (chi_cell_hist_pallas).
//
// Bound: one read of every mask byte plus one write of the (B, G, G, NB)
// int32 histograms, over 3.35 TB/s on an H100 SXM; the work per pixel
// (NB-1 compares and one shared-memory atomic) is small beside it.
//
// Design.  The TPU kernel turns the per-cell segment sum into a selector
// matmul because the TPU has no fast scatter.  Hopper has shared-memory
// atomics, so the kernel scatters directly: one block per (mask, row of
// cells) keeps a G x NB int histogram in shared memory, every thread bins
// its pixels (bin = number of interior edges <= m, compared in f32, which
// is searchsorted(edges, m, side="right") as build_chi_np computes it) and
// adds one to the cell's bin, then the block writes its G x NB counts out.
// Cell boundaries come in as row/col bound arrays ((i*H)//G), so a grid
// that does not divide H or W is served by the same kernel.  The prefix
// sums that turn histograms into the CHI table stay in torch (cumsum).
#include "common.cuh"

__global__ void __launch_bounds__(kThreads)
chi_cell_hist_kern(const float* __restrict__ masks,
                   const float* __restrict__ edges,  // (NB-1,)
                   const int* __restrict__ row_bounds,  // (G+1,)
                   const int* __restrict__ col_bounds,  // (G+1,)
                   int H, int W, int G, int NB,
                   int* __restrict__ out) {  // (B, G, G, NB)
  extern __shared__ int smem[];
  int* hist = smem;                 // G * NB
  int* col_cell = hist + G * NB;    // W
  float* edge = reinterpret_cast<float*>(col_cell + W);  // NB - 1
  const int b = blockIdx.x;
  const int i = blockIdx.y;
  for (int k = threadIdx.x; k < G * NB; k += blockDim.x) hist[k] = 0;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    // searchsorted(col_bounds, c, side="right") - 1, clipped to [0, G-1]
    int j = -1;
    for (int q = 0; q <= G; ++q) j += (col_bounds[q] <= c);
    col_cell[c] = min(max(j, 0), G - 1);
  }
  for (int k = threadIdx.x; k < NB - 1; k += blockDim.x) edge[k] = edges[k];
  __syncthreads();
  // Rows [rb[i], rb[i+1]) are exactly the rows whose cell row is i.
  const int r0 = row_bounds[i], r1 = row_bounds[i + 1];
  const float* m = masks + ((size_t)b * H + r0) * W;
  const int n = (r1 - r0) * W;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const float x = __ldg(m + idx);
    int bin = 0;
    for (int k = 0; k < NB - 1; ++k) bin += (edge[k] <= x);
    atomicAdd(&hist[col_cell[idx % W] * NB + bin], 1);
  }
  __syncthreads();
  int* o = out + ((size_t)b * G + i) * G * NB;
  for (int k = threadIdx.x; k < G * NB; k += blockDim.x) o[k] = hist[k];
}

extern "C" int chi_cell_hist_launch(const void* masks, const void* edges,
                                    const void* row_bounds,
                                    const void* col_bounds, int B, int H,
                                    int W, int G, int NB, void* out,
                                    void* stream) {
  const dim3 grid(B, G);
  const size_t smem = sizeof(int) * ((size_t)G * NB + W) +
                      sizeof(float) * (size_t)(NB > 1 ? NB - 1 : 0);
  chi_cell_hist_kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(masks), static_cast<const float*>(edges),
      static_cast<const int*>(row_bounds), static_cast<const int*>(col_bounds),
      H, W, G, NB, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
