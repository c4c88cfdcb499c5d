// Shared device helpers for the MaskSearch CUDA kernels (sm_90a).
//
// Every kernel in this directory is an exact integer-count reduction over
// mask pixels, so the helpers are: 16-byte vector loads converted to float,
// and a warp-shuffle + shared-memory block sum.  Each .cu file exports a
// plain C launch function (no PyTorch headers), loaded with ctypes; the
// launch returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mask element types, as the Python wrappers encode them.
enum { DT_F32 = 0, DT_BF16 = 1 };

constexpr int kThreads = 256;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  __device__ __forceinline__ static float to_f(float x) { return x; }
  // One 32-bit word of a vector load -> its elements.
  __device__ __forceinline__ static void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // bf16 -> f32 is exact, so a compare in f32 against a threshold that was
  // already rounded to bf16 is the same compare as one done in bf16.
  __device__ __forceinline__ static float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // Little-endian: the low half-word is the lower-addressed element.
  __device__ __forceinline__ static void unpack(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};

// Load Elem<T>::VEC elements from a 16-byte-aligned address, as floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  constexpr int PER_WORD = Elem<T>::VEC / 4;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  Elem<T>::unpack(raw.x, v);
  Elem<T>::unpack(raw.y, v + PER_WORD);
  Elem<T>::unpack(raw.z, v + 2 * PER_WORD);
  Elem<T>::unpack(raw.w, v + 3 * PER_WORD);
}

// Which column chunks (or columns) and rows of a box a thread reads, when
// the box's nk chunks of a row are spread over min(nk, blockDim.x) threads
// and blockDim.x / min(nk, blockDim.x) rows go per step: chunks
// first + col, first + col + lpr, ...; rows first + row, first + row + rps,
// ...  A thread keeps its column chunk for every row it reads.
struct Split {
  int col, lpr, row, rps;
  bool active;
};

__device__ __forceinline__ Split split_of(int nk) {
  Split s;
  s.lpr = min(nk, (int)blockDim.x);
  s.rps = blockDim.x / s.lpr;
  s.col = threadIdx.x % s.lpr;
  s.row = threadIdx.x / s.lpr;
  s.active = threadIdx.x < s.lpr * s.rps;
  return s;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum; the result is valid in thread 0.  Every thread of the
// block must call it.  `scratch` holds at least 32 ints; the leading
// barrier makes back-to-back calls safe.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nwarps) ? scratch[threadIdx.x] : 0;
  if (warp == 0) v = warp_sum(v);
  return v;
}
