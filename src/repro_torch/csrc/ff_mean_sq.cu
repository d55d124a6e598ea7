// FF RMSNorm statistic: the compensated mean of squares of every row,
// mean_sq(x)[r] = hi(sum_j x[r, j]^2) / C, the sum carried in float-float.
//
// Replaces the TPU kernel src/repro/kernels/ff_fused.py::run_pallas on the
// mean_sq program (x*x).sum() (src/repro/ff/dispatch.py:675-688).
//
// What bounds it on this card: the statistic reads each element once
// (4 bytes) and spends 14 f32 instructions on it (the square, two TwoSums,
// one add), about 3.5 instructions per byte, so a large input would be
// bound by memory bandwidth.  On the serving path the inputs are small
// ((B, 2048) in decode, (S, 2048) in prefill, 32 KB to 512 KB), so a
// launch is bound by its latency, not by either rate.
//
// Design: one block per row and 128 threads.  Thread l plays TPU lane l:
// it walks columns l, l+128, ... (a warp reads 32 consecutive floats) with
// the (s, c, cc) Neumaier update of the reference's _lane_cascade, in
// registers.  One thread then folds the 128 lane triples in lane order, as
// _fold_lanes does (ffk::LaneSum and ffk::fold_lanes).  Keeping the lanes and their order keeps the
// reference's summation order (not its blocking), so the result agrees
// with the plain version (ff_sum_blocked with block=128) to <= 1 ulp and
// in practice to the bit.

#include "ff_eft.cuh"

namespace {

using ffk::kLanes;

__global__ void __launch_bounds__(kLanes)
mean_sq_kernel(const float* __restrict__ x, float* __restrict__ out,
               int cols) {
  using namespace ffk;
  __shared__ float sh[3 * kLanes + 2];
  const float* row = x + static_cast<size_t>(blockIdx.x) * cols;
  LaneSum ln;
  for (int j = threadIdx.x; j < cols; j += kLanes) {
    float v = row[j];
    ln.add(mul(v, v));
  }
  const ff2 f = fold_lanes(ln, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = dvd(f.hi, static_cast<float>(cols));
}

}  // namespace

// x: (rows, cols) f32, contiguous; out: (rows,) f32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_mean_sq_f32(const float* x, float* out, int rows, int cols,
                              cudaStream_t stream) {
  if (rows > 0) mean_sq_kernel<<<rows, kLanes, 0, stream>>>(x, out, cols);
  return static_cast<int>(cudaGetLastError());
}
