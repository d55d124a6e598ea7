// The FF elementary functions over hi/lo planes, one launch each: exp,
// expm1, log, log1p, tanh, sigmoid, erf, gelu, silu (two planes in) and
// pow (four).
//
// Replaces the TPU kernel src/repro/kernels/ff_math.py::math_elementwise,
// which runs the ffmath.UNARY22 / pow22 bodies on the kernel EFTs over
// (128, 512) VMEM tiles, evaluating every branch of each function and
// selecting with jnp.where.
//
// What bounds it on this card: each element reads 8 (16 for pow) and
// writes 8 bytes, and costs from ~250 f32 instructions (exp, log) to
// several thousand (erf's series: 16 alternating and 59 positive terms,
// each a Mul22 and one or two Div22): 30-300 instructions per byte, far
// above the ~10 per byte at which the H100's memory keeps up, so the
// instruction rate bounds every function.
//
// Design: one thread per element in a grid-stride loop with strided
// operand planes (ff_planes.cuh), one kernel per function (a template
// instance: each carries only its own live set).  The device twins of
// ff_eft.cuh branch where the reference selects, so a thread evaluates one
// erf band, not three; a warp whose elements straddle a seam runs both
// sides.  erf's three bands stay out of line (__noinline__): the series
// loops keep four FF accumulators live; -Xptxas -v in
// build/.../libff_math.log gives each kernel's registers and spills.
// Each element is its plain version's bits (kernels/ff_math.py
// math_elementwise_plain: the same op sequences).

#include "ff_eft.cuh"
#include "ff_planes.cuh"

namespace {

using ffk::ff2;
using ffk::Planes;

// Same order as MATH_OPS in kernels/ff_math.py.
enum Op : int { EXP, EXPM1, LOG, LOG1P, TANH, SIGMOID, ERF, GELU, SILU, POW };

template <int OP>
__device__ __forceinline__ ff2 apply(float h, float l, float bh, float bl) {
  using namespace ffk;
  if constexpr (OP == EXP) return exp22(h, l);
  else if constexpr (OP == EXPM1) return expm122(h, l);
  else if constexpr (OP == LOG) return log22(h, l);
  else if constexpr (OP == LOG1P) return log1p22(h, l);
  else if constexpr (OP == TANH) return tanh22(h, l);
  else if constexpr (OP == SIGMOID) return sigmoid22(h, l);
  else if constexpr (OP == ERF) return erf22(h, l);
  else if constexpr (OP == GELU) return gelu22(h, l);
  else if constexpr (OP == SILU) return silu22(h, l);
  else return pow22(h, l, bh, bl);
}

template <int OP>
__global__ void __launch_bounds__(256)
math_kernel(const __grid_constant__ Planes t) {
  ffk::for_each_element(t, [&](long long i, auto r, auto c) {
    const float h = ffk::load(t, 0, r, c), l = ffk::load(t, 1, r, c);
    float bh = 0.0f, bl = 0.0f;
    if constexpr (OP == POW) {
      bh = ffk::load(t, 2, r, c);
      bl = ffk::load(t, 3, r, c);
    }
    const ff2 v = apply<OP>(h, l, bh, bl);
    t.out_hi[i] = v.hi;
    t.out_lo[i] = v.lo;
  });
}

template <int OP>
int launch(const Planes& t, int grid, cudaStream_t stream) {
  math_kernel<OP><<<grid, 256, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size of struct Planes, which the Python wrapper mirrors.
extern "C" int ff_math_planes_bytes() { return sizeof(Planes); }

// planes: a struct Planes (op, operand planes, outputs) in host memory,
// copied into the launch parameters.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int ff_math_f32(const void* planes, cudaStream_t stream) {
  const Planes& t = *static_cast<const Planes*>(planes);
  const long long n = t.rows * t.cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 8, &grid)) return err;
  switch (t.op) {
    case EXP: return launch<EXP>(t, grid, stream);
    case EXPM1: return launch<EXPM1>(t, grid, stream);
    case LOG: return launch<LOG>(t, grid, stream);
    case LOG1P: return launch<LOG1P>(t, grid, stream);
    case TANH: return launch<TANH>(t, grid, stream);
    case SIGMOID: return launch<SIGMOID>(t, grid, stream);
    case ERF: return launch<ERF>(t, grid, stream);
    case GELU: return launch<GELU>(t, grid, stream);
    case SILU: return launch<SILU>(t, grid, stream);
    case POW: return launch<POW>(t, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
