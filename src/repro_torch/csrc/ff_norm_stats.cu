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
// What bounds it on this card: x is read once (4 bytes an element) and
// each element costs ~28 f32 instructions (two cascades of 13, a subtract
// and a square), ~7 instructions a byte, close to the card's ratio of f32
// issue to memory rate (~10): memory bounds a large input, with the
// instructions not far behind.  Each row also pays two serial folds of
// its 128 lane triples, ~1.8 us each on one thread, and must stay on
// chip between its two sums: at 4096 columns an SM holds 13 rows, so the
// copies of one set of rows and the sums of the last do not overlap.
//
// Design (csrc/ff_rows.cuh; the path is the wrapper's plan,
// kernels/ff_fused.py row_plan): four warps a row, thread l lane l, for
// both sums; two rows a block, whose folds one warp runs at once.  The
// row is copied into shared memory with 16-byte cp.async, all of it in
// flight at once, or read there by the first sum, so x is read from
// device memory once and the centred sum reads shared memory.
//
// Re-read (path kReread): where the card holds every row at once and
// each SM has one, the two serial folds set the time and the rows fit
// in L1, so the centred sum reads x again, from L1, in one block a row
// of 128 threads whose fold is ffk::fold_lanes (the port's first design):
// measured faster there than any form of the staged kernel (PERF.md).
// Same op sequence as the plain version (kernels/ff_fused.py
// ff_norm_stats_plain): its bits on every path.

#include "ff_rows.cuh"

namespace {

using namespace ffr;
using ffk::dvd;
using ffk::mul;
using ffk::sub;

__global__ void __launch_bounds__(kMaxThreads)
norm_stats_kernel(const float* __restrict__ x, float* __restrict__ mu_out,
                  float* __restrict__ var_out, int rows, int cols,
                  int path) {
  extern __shared__ float4 smem4[];
  const int W = blockDim.x / kLanes, g = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const Rows b{reinterpret_cast<float*>(smem4), row_stride(cols, 1),
               padded(cols), W};
  const int row = blockIdx.x * W + g;
  const int r = row < rows ? row : rows - 1;      // a spare row: rows - 1
  const float* xr = x + static_cast<size_t>(r) * cols;
  float* plane = b.smem + g * b.stride;
  const float n = static_cast<float>(cols);

  LaneSum s1, s2;
  stage_row(plane, xr, cols, path, t);
  first_pass(xr, plane, cols, path, t, [&](float e) { s1.add(e); });
  const float mu = dvd(fold_row(s1, b, g, t).hi, n);
  each_col(cols, t, [&](int j) {
    const float d = sub(plane[j], mu);
    s2.add(mul(d, d));
  });
  const float var = dvd(fold_row(s2, b, g, t).hi, n);
  if (t == 0 && row < rows) {
    mu_out[row] = mu;
    var_out[row] = var;
  }
}

// Path kReread: one block a row, thread l lane l, both sums from device
// memory (the second from L1).
__global__ void __launch_bounds__(kLanes)
norm_stats_reread(const float* __restrict__ x, float* __restrict__ mu_out,
                  float* __restrict__ var_out, int cols) {
  __shared__ float sh[3 * kLanes + 2];
  const float* xr = x + static_cast<size_t>(blockIdx.x) * cols;
  const int t = threadIdx.x;
  const float n = static_cast<float>(cols);
  LaneSum s1, s2;
  for (int j = t; j < cols; j += kLanes) s1.add(xr[j]);
  const float mu = dvd(ffk::fold_lanes(s1, sh).hi, n);
  for (int j = t; j < cols; j += kLanes) {
    const float d = sub(xr[j], mu);
    s2.add(mul(d, d));
  }
  const float var = dvd(ffk::fold_lanes(s2, sh).hi, n);
  if (t == 0) {
    mu_out[blockIdx.x] = mu;
    var_out[blockIdx.x] = var;
  }
}

}  // namespace

// x: (rows, cols) f32, contiguous; mu, var: (rows,) f32.  path (enum Path
// of ff_rows.cuh): the row copied into shared memory by cp.async, 4 bytes
// a copy (0) or 16 (1: x 16-byte aligned and cols % 4 == 0), read there
// by the first sum (2), or read twice from device memory by one block a
// row (3); rows_per_block: rows a block of paths 0-2 (fewer where they do
// not fit).  Returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for a plan the kernel cannot run).
extern "C" int ff_norm_stats_f32(const float* x, float* mu, float* var,
                                 int rows, int cols, int path,
                                 int rows_per_block, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const int W = rows_per_block;
  if (path == kReread) {
    norm_stats_reread<<<rows, kLanes, 0, stream>>>(x, mu, var, cols);
    return static_cast<int>(cudaGetLastError());
  }
  if (path < kStaged4 || path > kStreamed)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<norm_stats_kernel>(rows, cols, kLanes, W, 1, stream, x,
                                        mu, var, rows, cols, path);
}
