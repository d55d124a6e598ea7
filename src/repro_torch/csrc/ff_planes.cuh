// Strided operand planes of the elementwise kernels (ff_elementwise.cu,
// ff_math.cu): each operand is a 2-D f32 plane read through its (row,
// column) element strides, 0 along a dimension it broadcasts over, so a
// scalar, row or column operand is never materialised.  Mirrored by
// _Planes in kernels/ff_elementwise.py (checked through
// <lib>_planes_bytes at the first launch).
#pragma once

#include <cuda_runtime.h>

namespace ffk {

constexpr int kMaxIn = 4;

struct Planes {
  int op, n_in;
  long long rows, cols;
  const float* in[kMaxIn];
  long long rs[kMaxIn], cs[kMaxIn];   // element strides, 0: broadcast
  float* out_hi;                      // (rows, cols), contiguous
  float* out_lo;
};

__device__ __forceinline__ float load(const Planes& t, int p, long long r,
                                      long long c) {
  return t.in[p][r * t.rs[p] + c * t.cs[p]];
}

// One thread per output element, in a grid-stride loop over the
// rows x cols outputs in row-major order: body(t, i, r, c) for each.
// 32-bit index arithmetic where the extent fits.
template <typename Body>
__device__ __forceinline__ void for_each_element(const Planes& t,
                                                 Body body) {
  const long long n = t.rows * t.cols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n < (1LL << 31)) {
    const int cols = static_cast<int>(t.cols);
    for (; i < n; i += stride) {
      const int ii = static_cast<int>(i);
      const int r = ii / cols;
      body(i, r, ii - r * cols);
    }
  } else {
    for (; i < n; i += stride) {
      const long long r = i / t.cols;
      body(i, r, i - r * t.cols);
    }
  }
}

// The grid of an elementwise launch: one thread per element, at most
// blocks_per_sm blocks of `threads` per SM (the loop strides over the
// rest).  Returns 0 and sets *grid, or a CUDA error.
inline int elementwise_grid(long long n, int threads, int blocks_per_sm,
                            int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + threads - 1) / threads;
  const long long cap = static_cast<long long>(sms) * blocks_per_sm;
  *grid = static_cast<int>(blocks < cap ? blocks : cap);
  return 0;
}

}  // namespace ffk
