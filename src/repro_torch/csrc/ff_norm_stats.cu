// LayerNorm statistics of every row in one launch: the compensated mean
// and the centred variance,
//
//   mu  = hi(sum_j x[r, j]) / C
//   var = hi(sum_j (x[r, j] - mu)^2) / C
//
// each sum carried in float-float over the TPU kernel's 128 lanes.
//
// Replaces the TPU kernel src/repro/kernels/ff_fused.py::ff_norm_stats
// (_norm_stats_kernel), which holds whole rows (up to MAX_FUSED_COLS =
// 16384 columns) in VMEM so that x is read from HBM once.
//
// What bounds it on this card: x is read once from device memory (4 bytes
// per element; the second pass finds the row in L2) and each element
// costs ~30 f32 instructions (two cascades, a subtract and a square),
// about 8 instructions per byte: memory bandwidth bounds a large input.
//
// Design: one block per row and 128 threads, thread l playing TPU lane l
// (columns l, l+128, ...) with the (s, c, cc) Neumaier update of the
// reference's _lane_cascade; thread 0 folds the lanes in lane order
// (_fold_lanes): ffk::LaneSum and ffk::fold_lanes, as csrc/ff_mean_sq.cu.  Same op sequence as the plain
// version (kernels/ff_fused.py ff_norm_stats_plain): its bits.

#include "ff_eft.cuh"

namespace {

using ffk::kLanes;

__global__ void __launch_bounds__(kLanes)
norm_stats_kernel(const float* __restrict__ x, float* __restrict__ mu_out,
                  float* __restrict__ var_out, int cols) {
  using namespace ffk;
  __shared__ float sh[3 * kLanes + 2];
  const float* row = x + static_cast<size_t>(blockIdx.x) * cols;
  const int lane = threadIdx.x;
  const float n = static_cast<float>(cols);
  LaneSum s1;
  for (int j = lane; j < cols; j += kLanes) s1.add(row[j]);
  const float mu = dvd(fold_lanes(s1, sh).hi, n);
  LaneSum s2;
  for (int j = lane; j < cols; j += kLanes) {
    const float d = sub(row[j], mu);
    s2.add(mul(d, d));
  }
  const float var = dvd(fold_lanes(s2, sh).hi, n);
  if (lane == 0) {
    mu_out[blockIdx.x] = mu;
    var_out[blockIdx.x] = var;
  }
}

}  // namespace

// x: (rows, cols) f32, contiguous; mu, var: (rows,) f32.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_norm_stats_f32(const float* x, float* mu, float* var,
                                 int rows, int cols, cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    norm_stats_kernel<<<rows, kLanes, 0, stream>>>(x, mu, var, cols);
  return static_cast<int>(cudaGetLastError());
}
