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
// result once (softmax: 8 bytes an element) for ~40 f32 instructions an
// element (expf, the cascade, the IEEE division), so memory bounds them,
// logsumexp's 4 bytes only just; the accurate modes spend ~250
// instructions an element on exp22 and Div22, so instructions bound them.
// Each row also pays a serial fold of its 128 lane triples (~1.8 us on
// one thread) and stays on chip from its max to its output.
//
// Design (csrc/ff_rows.cuh; the path is the wrapper's plan,
// kernels/ff_fused.py row_plan): the row copied into shared memory with
// 16-byte cp.async, all of it in flight at once, or, for short rows the
// card holds all at once, read there by the max pass as it goes; four
// warps a row, thread l lane l; x read from device memory once.  The max
// is each thread's running max, five warp shuffles and a word a warp, no
// serial loop.  The fast modes overwrite x with e = expf(x - m) in the
// sum pass, so the output pass divides the same e (no second expf); the
// accurate modes overwrite x with eh (softmax; el in a second plane) or
// el (logsumexp) for the el pass and the output.  Two rows a block in
// the accurate modes, whose folds one warp runs at once; one in the fast
// modes.  Same op sequences as the plain version (kernels/ff_fused.py
// ff_softmax_plain), so the accurate results are its bits and the fast
// ones are to the card's expf/logf, as torch's.

#include "ff_rows.cuh"

namespace {

using namespace ffr;
using ffk::add;
using ffk::dvd;
using ffk::sub;

constexpr int kMaxCols = 16384;

// One element's exponentials, summed into the lane (eh now; el in the
// el pass): the accurate ones (exp22 on an exact TwoSum shift) or expf.
template <bool kAccurate>
__device__ __forceinline__ ff2 exp_of(float x, float m) {
  if constexpr (kAccurate) {
    const ff2 d = ffk::two_sum(x, -m);
    return ffk::exp22(d.hi, d.lo);
  } else {
    return {expf(sub(x, m)), 0.0f};
  }
}

template <bool kAccurate>
__device__ __forceinline__ float out_of(ff2 e, ff2 f) {
  if constexpr (kAccurate)
    return ffk::div22(e, f).hi;
  else
    return dvd(e.hi, f.hi);
}

template <bool kAccurate>
__device__ __forceinline__ float lse_of(ff2 f, float m) {
  if constexpr (kAccurate)
    return ffk::add212(ffk::log22(f.hi, f.lo), m).hi;
  else
    return add(m, logf(f.hi));
}

// Planes a row: x, overwritten by eh (softmax, accurate), el (logsumexp,
// accurate) or e (fast); el of the accurate softmax in a second plane.
template <bool kSoftmax, bool kAccurate>
constexpr int kPlanes = kSoftmax && kAccurate ? 2 : 1;

template <bool kSoftmax, bool kAccurate>
__global__ void __launch_bounds__(kMaxThreads)
softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
               int rows, int cols, int path) {
  constexpr int planes = kPlanes<kSoftmax, kAccurate>;
  extern __shared__ float4 smem4[];
  const int W = blockDim.x / kLanes, g = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const Rows b{reinterpret_cast<float*>(smem4), row_stride(cols, planes),
               planes * padded(cols), W};
  const int row = blockIdx.x * W + g;
  const int r = row < rows ? row : rows - 1;      // a spare row: rows - 1
  const float* xr = x + static_cast<size_t>(r) * cols;
  float* pa = b.smem + g * b.stride;              // x, then e / eh / el
  float* pb = pa + padded(cols);                  // el (softmax, accurate)

  LaneSum ln;
  float m = -ffk::inf32();
  stage_row(pa, xr, cols, path, t);
  first_pass(xr, pa, cols, path, t, [&](float e) { m = max_nan(m, e); });
  m = row_max(m, b.sh(g), t);
  // the sum pass: e (or eh) into the lane, kept in place of x
  auto sum = [&](int j) {
    const ff2 ex = exp_of<kAccurate>(pa[j], m);
    ln.add(ex.hi);
    pa[j] = kAccurate && !kSoftmax ? ex.lo : ex.hi;
    if (kAccurate && kSoftmax) pb[j] = ex.lo;
  };
  if constexpr (kAccurate) {
#pragma unroll 2
    for (int j = t; j < cols; j += kLanes) sum(j);
    each_col(cols, t, [&](int j) { ln.add(kSoftmax ? pb[j] : pa[j]); });
  } else {
    for (int j = t; j < cols; j += kLanes) sum(j);
  }
  const ff2 f = fold_row(ln, b, g, t);
  if (row >= rows) return;
  if constexpr (kSoftmax) {
    float* o = out + static_cast<size_t>(row) * cols;
    each_col(cols, t, [&](int j) {
      o[j] = out_of<kAccurate>({pa[j], kAccurate ? pb[j] : 0.0f}, f);
    });
  } else if (t == 0) {
    out[row] = lse_of<kAccurate>(f, m);
  }
}

template <bool kSoftmax, bool kAccurate>
int launch(const float* x, float* out, int rows, int cols, int path, int W,
           cudaStream_t stream) {
  return launch_rows<softmax_kernel<kSoftmax, kAccurate>>(
      rows, cols, kLanes, W, kPlanes<kSoftmax, kAccurate>, stream, x, out,
      rows, cols, path);
}

}  // namespace

// x: (rows, cols) f32, contiguous, cols <= 16384; out: (rows, cols) for
// softmax (mode 0), (rows,) for logsumexp (mode 1).  path (0-2),
// rows_per_block: as ff_norm_stats_f32.  Returns the CUDA error of the
// launch (0 on success; cudaErrorInvalidValue for a plan the kernel
// cannot run).
extern "C" int ff_softmax_f32(const float* x, float* out, int rows, int cols,
                              int mode, int accurate, int path,
                              int rows_per_block, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (cols > kMaxCols || path < kStaged4 || path > kStreamed)
    return static_cast<int>(cudaErrorInvalidValue);
  const int W = rows_per_block;
  if (mode == 0)
    return accurate ? launch<true, true>(x, out, rows, cols, path, W, stream)
                    : launch<true, false>(x, out, rows, cols, path, W, stream);
  return accurate ? launch<false, true>(x, out, rows, cols, path, W, stream)
                  : launch<false, false>(x, out, rows, cols, path, W, stream);
}
