// The compensated row sum: x (R, C) f32 -> one FF value per row, with the
// TPU kernel's summation order.
//
// Replaces the TPU kernel src/repro/kernels/ff_reduce.py::ff_rowsum, whose
// grid walks the columns in (br, bc) blocks, carrying `lane` (s, c, cc)
// Neumaier accumulators per row in VMEM scratch from block to block (lane
// l takes columns l, l + lane, ... in order; zero padding past C adds
// nothing), then folds the lanes exactly, lane 0 first.
//
// What bounds it on this card: x is read once (4 bytes per element) for a
// 13-instruction cascade step, ~3 instructions per byte: memory bandwidth
// bounds a large input; a short row is bound by the sequential fold of its
// lanes (12 dependent instructions per lane, in one thread).
//
// Design: one block of `lanes` threads per row, thread l playing lane l:
// the grid's sequential column dimension becomes the loop inside the
// thread (ffk::LaneSum), and the fold is ffk::fold_lanes_n (the
// LaneSum/fold_lanes scheme of the whole-row kernels, for any lane count:
// the wrapper passes the reference's lane = min(lane, bc, C)).  Loads of a
// warp are 32 consecutive floats.  Each row is its plain version's bits
// (kernels/ff_reduce.py ff_rowsum_plain).

#include "ff_eft.cuh"

namespace {

__global__ void rowsum_kernel(const float* __restrict__ x, long long ld,
                              int cols, float* __restrict__ hi,
                              float* __restrict__ lo) {
  extern __shared__ float sh[];          // 3 * lanes + 2
  const int lanes = blockDim.x;
  const float* row = x + static_cast<long long>(blockIdx.x) * ld;
  ffk::LaneSum acc;
  for (int j = threadIdx.x; j < cols; j += lanes) acc.add(row[j]);
  const ffk::ff2 f = ffk::fold_lanes_n(acc, sh, lanes);
  if (threadIdx.x == 0) {
    hi[blockIdx.x] = f.hi;
    lo[blockIdx.x] = f.lo;
  }
}

}  // namespace

// x: (rows, cols) f32 rows `ld` elements apart, unit column stride;
// hi, lo: (rows,) f32; lanes in [1, 1024].  Returns the CUDA error of the
// launch (0 on success).
extern "C" int ff_rowsum_f32(const float* x, long long ld, float* hi,
                             float* lo, int rows, int cols, int lanes,
                             cudaStream_t stream) {
  if (lanes < 1 || lanes > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const size_t shared = (3 * static_cast<size_t>(lanes) + 2) * sizeof(float);
    rowsum_kernel<<<rows, lanes, shared, stream>>>(x, ld, cols, hi, lo);
  }
  return static_cast<int>(cudaGetLastError());
}
