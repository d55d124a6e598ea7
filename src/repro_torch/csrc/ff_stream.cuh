// Streaming over flat f32 arrays for the memory-bound kernels
// (ff_elementwise.cu's flat path, ff_adamw.cu): 16-byte accesses, a flat
// 32-bit index with no division, and several packs a thread a step whose
// loads are all issued before any of their arithmetic, so that each SM
// keeps enough bytes in flight to cover the device memory's latency
// (3.35 TB/s over 132 SMs at ~0.7 us needs ~18 KB in flight an SM).
//
// The kernels of ff_planes.cuh (ff_math.cu, ff_elementwise.cu's strided
// path) do not include this header: their code stays as it is.
// tests/test_torch_stream_plan.py mirrors stream()'s schedule on the host
// and checks that it covers each index once.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ffstream {

constexpr int kThreads = 256;      // threads a block
constexpr int kVec = 4;            // floats a pack: 16-byte accesses
constexpr int kUnroll = 2;         // packs a thread a step

template <int W>
using Width = std::integral_constant<int, W>;

// Plain loads and stores (evict-first ones, __ldcs / __stcs, are up to 4%
// slower: benchmarks/stream_variants "cache hints").
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return *p;
}

template <typename T>
__device__ __forceinline__ void st(T* p, T v) {
  *p = v;
}

// W consecutive floats at p (p aligned to 4 W bytes) into x[0 .. W).
template <int W>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (W == 4) {
    const float4 v = ld(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = ld(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    static_assert(W == 1, "pack width 1, 2 or 4");
    x[0] = ld(p);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (W == 4) {
    st(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (W == 2) {
    st(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    static_assert(W == 1, "pack width 1, 2 or 4");
    st(p, x[0]);
  }
}

// The flat loop over n elements in packs of VEC (n < 2^30).  Pack j covers
// elements [VEC j, VEC j + VEC); a block's step takes kUnroll * blockDim.x
// consecutive packs, thread t the packs t, t + blockDim.x, ... of it (each
// warp's accesses contiguous), and the blocks stride over the steps (one
// step each on stream_grid's grid).  In a step, load(Width<VEC>, k, i)
// runs for each of the thread's packs k (element i = VEC j) before
// apply(Width<VEC>, k, i), which computes pack k and stores it.  The n % VEC elements after the last whole pack are the
// tail: thread t of the last block takes element n - n % VEC + t, through
// load and apply with Width<1> and k = 0.
template <int VEC, typename Load, typename Apply>
__device__ __forceinline__ void stream(int n, Load load_k, Apply apply_k) {
  const int packs = n / VEC;
  const int t = blockDim.x;
  const int step = gridDim.x * t * kUnroll;
  for (int j = blockIdx.x * t * kUnroll + threadIdx.x; j < packs;
       j += step) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (j + k * t < packs) load_k(Width<VEC>{}, k, (j + k * t) * VEC);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (j + k * t < packs) apply_k(Width<VEC>{}, k, (j + k * t) * VEC);
  }
  if constexpr (VEC > 1) {
    const int i = packs * VEC + static_cast<int>(threadIdx.x);
    if (blockIdx.x == gridDim.x - 1 && i < n) {
      load_k(Width<1>{}, 0, i);
      apply_k(Width<1>{}, 0, i);
    }
  }
}

// The grid of a stream() launch over n elements in packs of vec: one
// block a step, so that each thread runs the loop's body once (a grid of
// the blocks resident at once, striding over the steps, is 5-8% slower:
// benchmarks/stream_variants "4 blocks an SM").
inline int stream_grid(long long n, int vec) {
  const long long per_step = static_cast<long long>(kThreads) * kUnroll * vec;
  const long long blocks = n > 0 ? (n + per_step - 1) / per_step : 1;
  return static_cast<int>(blocks);
}

}  // namespace ffstream
