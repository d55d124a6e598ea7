// The AdamW leaf update with a float-float master weight, one element per
// thread step:
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
// Design: the leaf is one flat contiguous array, so a grid-stride loop
// with one element per thread per step, neighbouring threads on
// neighbouring addresses, is enough to stream it.  lr, b1, b2, bc1 and
// bc2 are computed on the device each step and read here through a
// pointer (no host sync); eps and wd arrive as f32.  The update is in
// place (the optimizer's state would not fit twice): every element is
// read before the same thread writes it, and no other thread touches it.
// Vector loads and one launch for all leaves are later work.

#include "ff_eft.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
adamw_kernel(const float* g, float* m, float* v, float* w, float* wlo,
             const float* __restrict__ scal, float eps, float wd,
             long long n) {
  using namespace ffk;
  const float lr = scal[0], b1 = scal[1], b2 = scal[2];
  const float bc1 = scal[3], bc2 = scal[4];
  const float c1 = sub(1.0f, b1), c2 = sub(1.0f, b2), neg_lr = -lr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i], mi = m[i], vi = v[i], wi = w[i], li = wlo[i];
    const float m2 = add(mul(b1, mi), mul(c1, gi));
    const float v2 = add(mul(b2, vi), mul(mul(c2, gi), gi));
    float upd = dvd(dvd(m2, bc1), add(__fsqrt_rn(dvd(v2, bc2)), eps));
    upd = add(upd, mul(wd, wi));
    const ff2 r = add212({wi, li}, mul(neg_lr, upd));
    w[i] = r.hi;
    wlo[i] = r.lo;
    m[i] = m2;
    v[i] = v2;
  }
}

}  // namespace

// g, m, v, w, wlo: n contiguous f32 each, five distinct arrays; m, v, w
// and wlo are updated in place.  scal: {lr, b1, b2, bc1, bc2} on the
// device.  Returns the CUDA error of the launch (0 on success).
extern "C" int ff_adamw_f32(const float* g, float* m, float* v, float* w,
                            float* wlo, const float* scal, float eps,
                            float wd, long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
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
