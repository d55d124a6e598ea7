// The row walk of the whole-row kernels (csrc/ff_softmax.cu,
// csrc/ff_norm_stats.cu) on Hopper.
//
// The TPU kernels sum a row over 128 lanes: lane l folds columns l,
// l + 128, ... in order into a Neumaier triple (ffk::LaneSum), and the 128
// triples are folded in lane order.  That order fixes the bits, so the
// walk keeps every lane's columns in order on one thread: four warps a
// row, thread l lane l, W rows a block.  The row is copied into shared
// memory with cp.async (16 bytes a copy where the row is 16-byte aligned
// and cols % 4 == 0, else 4), all of it in flight at once, and thread l
// walks lane l from there (a warp reads 32 consecutive words: no bank
// conflicts).  Streamed, the first pass reads x from device memory itself
// (4-byte loads, thread l column l: coalesced) and keeps each value in
// shared memory: its sums start as the row arrives.  Either way x is read
// from device memory once and stays on chip for the later passes.
//
// The fold stays serial and in lane order (fold_lanes' arithmetic): the
// threads of the row write their triples to the row's scratch, and one
// thread folds them: one warp folds all W rows of a block at once (lane
// w the block's row w, between two block barriers), so the 128 serial
// steps cost the block one warp's instructions, not W warps'.

#pragma once

#include "ff_eft.cuh"

namespace ffr {

using ffk::ff2;
using ffk::kLanes;
using ffk::LaneSum;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxRows = 8;              // rows a block at most
constexpr int kMaxThreads = kLanes * kMaxRows;
// the fold scratch: s, c, cc of the 128 lanes, then (fh, fl) and 2 spare
constexpr int kScratch = 3 * kLanes + 4;

// How a row gets into shared memory.
enum Path {
  kStaged4 = 0,      // cp.async, 4 bytes a copy
  kStaged16 = 1,     // cp.async, 16 bytes a copy (16-byte aligned rows)
  kStreamed = 2,     // the first pass's own 4-byte loads
  kReread = 3,       // ff_norm_stats only: its one-block-a-row kernel
};

__host__ __device__ inline int padded(int cols) {
  return (cols + kLanes - 1) / kLanes * kLanes;
}

// Floats of shared memory a row: `planes` planes of padded(cols) floats,
// then the fold scratch.  It is 4 mod 32 words, so that the block fold's
// lanes read the W scratches from distinct banks, and a multiple of 4,
// so that every plane is 16-byte aligned.
__host__ __device__ inline int row_stride(int cols, int planes) {
  return planes * padded(cols) + kScratch;
}

// NaN-propagating max, as torch.amax.  The max is exact, so any order
// gives its value; only the sign of a zero max can depend on the order,
// and it reaches no output (x - m and TwoSum(x, -m) give the same
// exponentials for m = +0 and m = -0).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The max over a row's 128 threads, to all of them: five shuffles, then
// one word a warp in sh (4 floats of the row's scratch, free until the
// first fold).  Every thread of the block calls it.
__device__ __forceinline__ float row_max(float m, float* sh, int t) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    m = max_nan(m, __shfl_xor_sync(kAll, m, off));
  if ((t & 31) == 0) sh[t >> 5] = m;
  __syncthreads();
  m = max_nan(max_nan(sh[0], sh[1]), max_nan(sh[2], sh[3]));
  __syncthreads();                 // read before the triples overwrite sh
  return m;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Copies a row into its plane with cp.async (path kStaged16 or
// kStaged4), all of it in flight at once, then waits for the copies and
// syncs the block; nothing for a streamed row.
__device__ __forceinline__ void stage_row(float* plane,
                                          const float* __restrict__ row,
                                          int cols, int path, int t) {
  if (path == kStreamed) return;
  if (path == kStaged16) {
    for (int i = 4 * t; i < cols; i += 4 * kLanes) cp_async16(plane + i, row + i);
  } else {
    for (int i = t; i < cols; i += kLanes) cp_async4(plane + i, row + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// f(j) for this thread's columns j = t, t + 128, ... < cols, in order,
// four at a time.
template <class F>
__device__ __forceinline__ void each_col(int cols, int t, F&& f) {
#pragma unroll 4
  for (int j = t; j < cols; j += kLanes) f(j);
}

// The first pass over a row: op(x[j]) for this thread's columns j = t,
// t + 128, ... in order.  Streamed: read from device memory (four loads
// in flight) and kept in the plane.  Staged: read from the plane.  The
// later passes read only this thread's own columns: no barrier.
template <class F>
__device__ __forceinline__ void first_pass(const float* __restrict__ row,
                                           float* plane, int cols, int path,
                                           int t, F&& op) {
  if (path == kStreamed) {
    each_col(cols, t, [&](int j) {
      const float v = row[j];
      plane[j] = v;
      op(v);
    });
  } else {
    each_col(cols, t, [&](int j) { op(plane[j]); });
  }
}

// One thread folds a scratch's 128 triples in lane order (the arithmetic
// of ffk::fold_lanes_n and of the reference's _fold_lanes) and leaves
// (fh, fl) after them.
__device__ __forceinline__ void fold_scratch(float* sh) {
  using namespace ffk;
  float fh = 0.0f, fl = 0.0f;
#pragma unroll 8
  for (int i = 0; i < kLanes; ++i) {
    ff2 t = two_sum(fh, sh[i]);
    float v = add(t.lo, add(add(fl, sh[kLanes + i]), sh[2 * kLanes + i]));
    ff2 f = fast_two_sum(t.hi, v);
    fh = f.hi;
    fl = f.lo;
  }
  sh[3 * kLanes] = fh;
  sh[3 * kLanes + 1] = fl;
}

// Where a block's rows are and who folds them.
struct Rows {
  float* smem;     // the block's dynamic shared memory
  int stride;      // floats a row (row_stride)
  int scratch;     // offset of the fold scratch in a row
  int W;           // rows of the block
  __device__ __forceinline__ float* sh(int g) const {
    return smem + g * stride + scratch;
  }
};

// The FF sum of row g of the block (its 128 lane triples, lane 0 first),
// to every thread of the row; ln is thread t's lane t.  Every thread of
// the block calls it.
__device__ __forceinline__ ff2 fold_row(const LaneSum& ln, const Rows& b,
                                        int g, int t) {
  float* sh = b.sh(g);
  sh[t] = ln.s;
  sh[kLanes + t] = ln.c;
  sh[2 * kLanes + t] = ln.cc;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < b.W) fold_scratch(b.sh(threadIdx.x));
  __syncthreads();
  return {sh[3 * kLanes], sh[3 * kLanes + 1]};
}

// The launch of row kernel kKernel over W rows a block, each with
// `planes` planes (no more rows than kMaxRows and than the device's
// opt-in shared memory holds): grid, block, shared memory; the opt-in to
// more than 48 KB of dynamic shared memory, once a kernel, to the
// device's limit.  Returns the CUDA error (0 on success).
template <auto kKernel, class... Args>
int launch_rows(int rows, int cols, int threads_a_row, int W, int planes,
                cudaStream_t stream, Args... args) {
  static int opt_in = -1;        // bytes this kernel may use
  if (opt_in < 0) {
    int dev = 0, most = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    opt_in = most;
  }
  const int row = row_stride(cols, planes) * 4;   // bytes
  W = W < kMaxRows ? W : kMaxRows;
  W = W < opt_in / row ? W : opt_in / row;
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  kKernel<<<(rows + W - 1) / W, threads_a_row * W,
            static_cast<size_t>(W) * row, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffr
