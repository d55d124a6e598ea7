// The AdamW leaf update with a float-float master weight, element by
// element:
//
//   m2  = b1*m + (1-b1)*g
//   v2  = b2*v + ((1-b2)*g)*g
//   upd = (m2/bc1) / (sqrt(v2/bc2) + eps) + wd*w
//   (w', wlo') = Add212((w, wlo), (-lr)*upd)
//
// Replaces the TPU kernel src/repro/kernels/ff_fused.py::run_pallas on the
// adamw_update program (src/repro/ff/dispatch.py:633-665, _adamw_chain
// through fusion.fused), in the reference's op order, so the four outputs
// are the plain version's bits.
//
// What bounds it on this card: each element reads g, m, v, w, wlo and
// writes w, wlo, m, v, 36 bytes, for ~26 f32 instructions (two divides
// and a square root among them), under one instruction per byte: memory
// bandwidth bounds it.  Over granite-3-2b's 2.63 B parameters a step
// moves 94.8 GB, 28.3 ms at 3.35 TB/s.
//
// Design: the leaf is one flat contiguous array, streamed (ff_stream.cuh):
// each thread takes kUnroll packs of kVec elements of all five arrays
// (16-byte loads and stores), issuing all of its loads before its
// arithmetic, with a 32-bit index, one block a step; the n % kVec
// elements past the last whole pack are a tail of 4-byte accesses.  Where
// a leaf is not 16-byte aligned, or has 2^30 elements or more, the earlier
// loop runs instead: one element a thread a step, 4-byte accesses, a
// 64-bit index (kernels/ff_fused.py adamw_plan picks).  lr, b1, b2, bc1
// and bc2 are computed on the device each step and read here through a
// pointer (no host sync); eps and wd arrive as f32.  The update is in
// place (the optimizer's state would not fit twice): every element is
// read before the same thread writes it, and no other thread touches it.
// One launch for all leaves is later work.

#include "ff_eft.cuh"
#include "ff_stream.cuh"

namespace {

using ffk::ff2;

// The step's scalars: lr, b1, b2, bc1, bc2 from the device, 1 - b1, 1 - b2.
struct Coef {
  float b1, b2, bc1, bc2, c1, c2, neg_lr, eps, wd;
};

__device__ __forceinline__ Coef coef(const float* __restrict__ scal,
                                     float eps, float wd) {
  using ffk::sub;
  const float lr = scal[0], b1 = scal[1], b2 = scal[2];
  return {b1, b2, scal[3], scal[4], sub(1.0f, b1), sub(1.0f, b2), -lr, eps,
          wd};
}

// One element's update: its w, wlo, m and v after the step.
__device__ __forceinline__ void update(const Coef& c, float gi, float& mi,
                                       float& vi, float& wi, float& li) {
  using namespace ffk;
  const float m2 = add(mul(c.b1, mi), mul(c.c1, gi));
  const float v2 = add(mul(c.b2, vi), mul(mul(c.c2, gi), gi));
  float upd = dvd(dvd(m2, c.bc1), add(__fsqrt_rn(dvd(v2, c.bc2)), c.eps));
  upd = add(upd, mul(c.wd, wi));
  const ff2 r = add212({wi, li}, mul(c.neg_lr, upd));
  wi = r.hi;
  li = r.lo;
  mi = m2;
  vi = v2;
}

constexpr int kThreads = 256;

// The 4-byte loop: one element a thread a step, any alignment and length.
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const float* g, float* m, float* v, float* w, float* wlo,
             const float* __restrict__ scal, float eps, float wd,
             long long n) {
  const Coef c = coef(scal, eps, wd);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float mi = m[i], vi = v[i], wi = w[i], li = wlo[i];
    update(c, g[i], mi, vi, wi, li);
    w[i] = wi;
    wlo[i] = li;
    m[i] = mi;
    v[i] = vi;
  }
}

// The streamed update: all five arrays 16-byte aligned, n < 2^30.
__global__ void __launch_bounds__(ffstream::kThreads)
adamw_stream_kernel(const float* g, float* m, float* v, float* w,
                    float* wlo, const float* __restrict__ scal, float eps,
                    float wd, int n) {
  constexpr int kV = ffstream::kVec;
  const Coef c = coef(scal, eps, wd);
  float x[ffstream::kUnroll][5][kV];          // g, m, v, w, wlo
  ffstream::stream<kV>(
      n,
      [&](auto width, int k, int i) {
        constexpr int W = decltype(width)::value;
        ffstream::load<W>(g + i, x[k][0]);
        ffstream::load<W>(m + i, x[k][1]);
        ffstream::load<W>(v + i, x[k][2]);
        ffstream::load<W>(w + i, x[k][3]);
        ffstream::load<W>(wlo + i, x[k][4]);
      },
      [&](auto width, int k, int i) {
        constexpr int W = decltype(width)::value;
#pragma unroll
        for (int e = 0; e < W; ++e)
          update(c, x[k][0][e], x[k][1][e], x[k][2][e], x[k][3][e],
                 x[k][4][e]);
        ffstream::store<W>(w + i, x[k][3]);
        ffstream::store<W>(wlo + i, x[k][4]);
        ffstream::store<W>(m + i, x[k][1]);
        ffstream::store<W>(v + i, x[k][2]);
      });
}

}  // namespace

// g, m, v, w, wlo: n contiguous f32 each, five distinct arrays; m, v, w
// and wlo are updated in place.  scal: {lr, b1, b2, bc1, bc2} on the
// device.  vector != 0: the streamed kernel (all five arrays 16-byte
// aligned, n < 2^30), else the 4-byte loop.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int ff_adamw_f32(const float* g, float* m, float* v, float* w,
                            float* wlo, const float* scal, float eps,
                            float wd, long long n, int vector,
                            cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (vector) {
    if (n >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = ffstream::stream_grid(n, ffstream::kVec);
    adamw_stream_kernel<<<grid, ffstream::kThreads, 0, stream>>>(
        g, m, v, w, wlo, scal, eps, wd, static_cast<int>(n));
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough blocks to fill every SM (8 blocks of 256 threads each), and
  // no more: the loop strides over the rest
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  adamw_kernel<<<grid, kThreads, 0, stream>>>(g, m, v, w, wlo, scal, eps, wd,
                                              n);
  return static_cast<int>(cudaGetLastError());
}
