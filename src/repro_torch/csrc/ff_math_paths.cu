// Which path the ff_math kernel's exp, expm1 and log take, element by
// element: far[i] = 1 where math_kernel<EXP> (exp22_fmapath), <EXPM1>
// (expm122_fmapath) or <LOG> (log22_fmapath) sends element i to the Dekker
// body (exp22 / expm122 / log22), else 0.
//
// Each element evaluates the *ok of the very functions those instances
// inline (exp22_fma, expm122_fma, log22_fma in ff_eft.cuh), built with the
// port's flags (no contraction, IEEE division), so the mask is the kernel's
// own test on the card, not a replay of it.  A check kernel, not on any model
// path: chip_smoke.py counts its mask per edge class and on the timed
// inputs, and holds it to math_variants.dekker_elements, the host's
// emulation that the CPU tests take their emulated paths' test from.

#include "ff_eft.cuh"
#include "ff_planes.cuh"

namespace {

constexpr int kExp = 0, kExpm1 = 1, kLog = 2;   // ff_math.cu's Op codes

template <int OP>
__global__ void __launch_bounds__(256)
dekker_elements_kernel(unsigned char* __restrict__ far,
                       const float* __restrict__ xh,
                       const float* __restrict__ xl, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    bool ok;
    if constexpr (OP == kExp) ffk::exp22_fma(xh[i], xl[i], &ok);
    else if constexpr (OP == kExpm1) ffk::expm122_fma(xh[i], xl[i], &ok);
    else ffk::log22_fma(xh[i], xl[i], &ok);
    far[i] = ok ? 0 : 1;
  }
}

}  // namespace

// op: 0 (exp), 1 (expm1) or 2 (log); far: n bytes; xh, xl: n contiguous
// f32 limbs each, on the card.  Returns the CUDA error of the launch (0 on
// success).
extern "C" int ff_math_dekker_elements(int op, void* far, const void* xh,
                                       const void* xl, long long n,
                                       cudaStream_t stream) {
  if (op != kExp && op != kExpm1 && op != kLog)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 8, &grid)) return err;
  auto* f = static_cast<unsigned char*>(far);
  const auto* h = static_cast<const float*>(xh);
  const auto* l = static_cast<const float*>(xl);
  if (op == kExp)
    dekker_elements_kernel<kExp><<<grid, 256, 0, stream>>>(f, h, l, n);
  else if (op == kExpm1)
    dekker_elements_kernel<kExpm1><<<grid, 256, 0, stream>>>(f, h, l, n);
  else
    dekker_elements_kernel<kLog><<<grid, 256, 0, stream>>>(f, h, l, n);
  return static_cast<int>(cudaGetLastError());
}
