// Compensated softmax / log-sum-exp over each row, one launch:
//
//   m = max_j x[r, j]
//   e = exp(x - m)                        (the f32 expf), or, accurate,
//   (eh, el) = exp22(TwoSum(x, -m))       (both limbs summed)
//   (fh, fl) = the 128-lane compensated sum of e (of eh, then el)
//   softmax:   e / fh,  or div22((eh, el), (fh, fl)).hi
//   logsumexp: m + log(fh),  or add212(log22(fh, fl), m).hi
//
// Replaces the TPU kernel src/repro/kernels/ff_fused.py::ff_softmax
// (_softmax_kernel), which holds whole rows (up to MAX_FUSED_COLS = 16384
// columns) in VMEM.
//
// What bounds it on this card: the fast modes read x once and write the
// result once (softmax: 8 bytes per element) for ~20 f32 instructions per
// element, so memory bounds them; the accurate modes spend ~250
// instructions per element on exp22 and Div22, so instructions bound them.
//
// Design: one block per row and 128 threads, thread l playing TPU lane l:
// it walks columns l, l+128, ... with the (s, c, cc) Neumaier update of
// the reference's _lane_cascade; thread 0 folds the 128 lanes in lane
// order (_fold_lanes).  Accurate mode cascades every eh of the lane, then
// every el, into the same accumulators (the reference's two planes in
// order).  The max is exact in any order.  The fast modes re-read x (L2)
// and recompute expf in the output pass; the accurate modes keep el
// (logsumexp) or eh and el (softmax) in dynamic shared memory, up to
// 128 KB at 16384 columns.  Same op sequences as the plain version
// (kernels/ff_fused.py ff_softmax_plain), so the accurate results are its
// bits and the fast ones are to the card's expf/logf, as torch's.

#include "ff_eft.cuh"

namespace {

using ffk::kLanes;
constexpr int kMaxCols = 16384;

// NaN-propagating max, as jnp.max and torch.amax.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <bool kSoftmax, bool kAccurate>
__global__ void __launch_bounds__(kLanes)
softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
               int cols) {
  using namespace ffk;
  extern __shared__ float planes[];        // accurate: el (and eh)
  __shared__ float sh[3 * kLanes + 2];
  const float* row = x + static_cast<size_t>(blockIdx.x) * cols;
  const int lane = threadIdx.x;

  float m = -inf32();
  for (int j = lane; j < cols; j += kLanes) m = max_nan(m, row[j]);
  sh[lane] = m;
  __syncthreads();
  if (lane == 0) {
    for (int i = 1; i < kLanes; ++i) m = max_nan(m, sh[i]);
    sh[3 * kLanes] = m;
  }
  __syncthreads();
  m = sh[3 * kLanes];
  __syncthreads();

  LaneSum ln;
  if (kAccurate) {
    float* el_s = planes;                  // el, then eh for softmax
    float* eh_s = planes + cols;
    for (int j = lane; j < cols; j += kLanes) {
      ff2 d = two_sum(row[j], -m);
      ff2 e = exp22(d.hi, d.lo);
      ln.add(e.hi);
      el_s[j] = e.lo;
      if (kSoftmax) eh_s[j] = e.hi;
    }
    for (int j = lane; j < cols; j += kLanes) ln.add(el_s[j]);
    const ff2 f = fold_lanes(ln, sh);
    if (kSoftmax) {
      float* o = out + static_cast<size_t>(blockIdx.x) * cols;
      for (int j = lane; j < cols; j += kLanes)
        o[j] = div22({eh_s[j], el_s[j]}, f).hi;
    } else if (lane == 0) {
      out[blockIdx.x] = add212(log22(f.hi, f.lo), m).hi;
    }
  } else {
    for (int j = lane; j < cols; j += kLanes) ln.add(expf(sub(row[j], m)));
    const ff2 f = fold_lanes(ln, sh);
    if (kSoftmax) {
      float* o = out + static_cast<size_t>(blockIdx.x) * cols;
      for (int j = lane; j < cols; j += kLanes)
        o[j] = dvd(expf(sub(row[j], m)), f.hi);
    } else if (lane == 0) {
      out[blockIdx.x] = ffk::add(m, logf(f.hi));
    }
  }
}

template <bool kSoftmax, bool kAccurate>
int launch(const float* x, float* out, int rows, int cols,
           cudaStream_t stream) {
  auto kernel = softmax_kernel<kSoftmax, kAccurate>;
  const size_t smem =
      kAccurate ? static_cast<size_t>(kSoftmax ? 2 : 1) * cols * 4 : 0;
  static bool opted_in = false;   // past 48 KB of dynamic shared memory
  if (kAccurate && !opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kSoftmax ? 2 : 1) * kMaxCols * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  kernel<<<rows, kLanes, smem, stream>>>(x, out, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, cols) f32, contiguous, cols <= 16384; out: (rows, cols) for
// softmax (mode 0), (rows,) for logsumexp (mode 1).  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_softmax_f32(const float* x, float* out, int rows, int cols,
                              int mode, int accurate, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0)
    return accurate ? launch<true, true>(x, out, rows, cols, stream)
                    : launch<true, false>(x, out, rows, cols, stream);
  return accurate ? launch<false, true>(x, out, rows, cols, stream)
                  : launch<false, false>(x, out, rows, cols, stream);
}
