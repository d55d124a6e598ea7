// The FF health probe's flag plane: for each (hi, lo) limb pair an f32
// code nonfinite + 2 unnormalized + 4 denormal_lo (0..7).
//
// Replaces the TPU kernel src/repro/kernels/ff_guard.py::guard_flags
// (_guard_kernel), which flattens the planes to 2-D, pads them to
// (8, 128)-aligned (256, 512) tiles and evaluates flag_planes per tile.
//
// What bounds it on this card: each element reads two f32 limbs and
// writes one f32 code (12 bytes) for about ten integer and f32
// instructions: far below the H100's ~10 instructions per byte of memory
// bandwidth, so memory bandwidth bounds it.
//
// Design: one thread per element in a grid-stride loop over contiguous
// planes (the wrapper makes them contiguous; there is no padding, so the
// ragged edge needs no mask beyond the loop bound).  The three flags come
// from the limbs' bits where the reference reads them so:
//   * finite: neither limb has the all-ones exponent;
//   * unnormalized: finite && |lo| > |hi| * 2^-24, the product rounded by
//     __fmul_rn, compared in IEEE f32 with subnormals kept (the build has
//     no -ftz and no fast math: |hi| * 2^-24 is subnormal below
//     |hi| = 2^-102, and a flushed product would change bit 1).  Gated on
//     finite, so a NaN or Inf limb sets bit 0 only;
//   * denormal_lo: finite && exponent(lo) == 0 && mantissa(lo) != 0, read
//     from the bits, never a float compare (so -0.0 and 0 are healthy).
// The bits are those of the plain version (kernels/ff_guard.py
// guard_flags_plain).

#include "ff_planes.cuh"

namespace {

__global__ void __launch_bounds__(256)
guard_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
             float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned int hb = __float_as_uint(hi[i]);
    const unsigned int lb = __float_as_uint(lo[i]);
    const unsigned int he = (hb >> 23) & 0xFFu, le = (lb >> 23) & 0xFFu;
    const bool finite = he != 0xFFu && le != 0xFFu;
    const float ahi = __uint_as_float(hb & 0x7FFFFFFFu);
    const float alo = __uint_as_float(lb & 0x7FFFFFFFu);
    // 2^-24 exactly
    const bool unnorm = finite && alo > __fmul_rn(ahi, 5.9604644775390625e-8f);
    const bool denorm = finite && le == 0u && (lb & 0x7FFFFFu) != 0u;
    out[i] = (finite ? 0.0f : 1.0f) + (unnorm ? 2.0f : 0.0f) +
             (denorm ? 4.0f : 0.0f);
  }
}

}  // namespace

// hi, lo: n contiguous f32 limbs each; out: n f32 codes.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_guard_f32(const float* hi, const float* lo, float* out,
                            long long n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 16, &grid)) return err;
  guard_kernel<<<grid, 256, 0, stream>>>(hi, lo, out, n);
  return static_cast<int>(cudaGetLastError());
}
