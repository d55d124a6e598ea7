// The paper's elementwise operators over hi/lo planes, one launch each:
// Add22, Mul22, Div22, Sqrt22, TwoSum and TwoProd.
//
// Replaces the TPU kernel src/repro/kernels/ff_elementwise.py::elementwise,
// which tiles the operands padded to (8, 128)-aligned (256, 512) blocks
// and pins a broadcast operand's BlockSpec to block 0 along the dimension
// it broadcasts over.
//
// What bounds it on this card: each output element reads two or four f32
// limbs and writes two (16 or 24 bytes) for 10-30 f32 instructions
// (TwoSum 6, Add22 20, Mul22 25 with the Dekker TwoProd, Div22 ~35): under
// 2 instructions per byte, far below the H100's ~10 instructions per byte
// of memory bandwidth, so memory bandwidth bounds it.
//
// Design: two paths, picked on the host (kernels/ff_elementwise.py
// elementwise_plan) and entered through two entry points.  The flat path
// (flat_kernel on ff_stream.cuh) takes every call whose operand planes
// are each dense row-major at the output's shape or a scalar: a flat
// 32-bit index with no division, each thread kUnroll packs of kVec
// elements (16-byte loads and stores) with all of its loads issued before
// its arithmetic, one block a step, so that enough bytes are in flight to
// keep HBM busy; a scalar operand is read once.  Where an operand or
// output is not 16-byte aligned (a view starting 1-3 floats past a
// boundary) the same loop runs with 4-byte accesses.  Every other layout
// (transposed, row- or column-broadcast operands) takes the strided path:
// one thread per output element in a grid-stride loop, each operand plane
// read through its (row, column) strides (ff_planes.cuh), stride 0 in
// place of the BlockSpec pinning.  Neither path pads, so the ragged edge
// needs no mask beyond the loop bound.  The block shape of the TPU kernel
// has no counterpart here: the wrapper validates it and the launch does
// not depend on it.  TwoProd is the Dekker split (ffk::two_prod), as the
// reference kernel's (src/repro/kernels/eft.py): the FMA form where one
// test proves Dekker's exact changed no op's time by 1% or more
// (repro_torch.benchmarks.stream_variants "FMA TwoProd").  Each element
// is the explicitly rounded op sequence of its plain version
// (kernels/ff_elementwise.py elementwise_plain): its bits.

#include "ff_eft.cuh"
#include "ff_planes.cuh"
#include "ff_stream.cuh"

namespace {

using ffk::ff2;
using ffk::Planes;

// Same order as EW_OPS in kernels/ff_elementwise.py.
enum Op : int { ADD22, MUL22, DIV22, SQRT22, TWO_PROD, TWO_SUM };

// Operand planes of OP: a's hi and lo, b's hi and lo (two f32 operands, or
// one FF for Sqrt22, otherwise).
template <int OP>
constexpr int kIn = OP == ADD22 || OP == MUL22 || OP == DIV22 ? 4 : 2;

template <int OP>
__device__ __forceinline__ ff2 apply(float a, float b, float c, float d) {
  using namespace ffk;
  if constexpr (OP == ADD22) return add22({a, b}, {c, d});
  else if constexpr (OP == MUL22) return mul22({a, b}, {c, d});
  else if constexpr (OP == DIV22) return div22({a, b}, {c, d});
  else if constexpr (OP == SQRT22) return sqrt22({a, b});
  else if constexpr (OP == TWO_PROD) return two_prod(a, b);
  else return two_sum(a, b);
}

template <int OP>
__global__ void __launch_bounds__(256)
elementwise_kernel(const __grid_constant__ Planes t) {
  ffk::for_each_element(t, [&](long long i, auto r, auto c) {
    using ffk::load;
    const float a = load(t, 0, r, c), b = load(t, 1, r, c);
    float x = 0.0f, y = 0.0f;
    if constexpr (kIn<OP> == 4) {
      x = load(t, 2, r, c);
      y = load(t, 3, r, c);
    }
    const ff2 v = apply<OP>(a, b, x, y);
    t.out_hi[i] = v.hi;
    t.out_lo[i] = v.lo;
  });
}

// The flat path: operand p is a scalar where bit p of `scalars` is set,
// else dense at the output's shape (element i at in[p][i]); rows * cols <
// 2^30.  VEC: ffstream::kVec (every dense plane and both outputs 16-byte
// aligned) or 1.
template <int OP, int VEC>
__global__ void __launch_bounds__(ffstream::kThreads)
flat_kernel(const __grid_constant__ Planes t, int scalars) {
  constexpr int kN = kIn<OP>;
  float s[kN];
#pragma unroll
  for (int p = 0; p < kN; ++p)
    s[p] = scalars >> p & 1 ? t.in[p][0] : 0.0f;
  float x[ffstream::kUnroll][kN][VEC];
  ffstream::stream<VEC>(
      static_cast<int>(t.rows * t.cols),
      [&](auto width, int k, int i) {
        constexpr int W = decltype(width)::value;
#pragma unroll
        for (int p = 0; p < kN; ++p) {
          if (scalars >> p & 1) {
#pragma unroll
            for (int e = 0; e < W; ++e) x[k][p][e] = s[p];
          } else {
            ffstream::load<W>(t.in[p] + i, x[k][p]);
          }
        }
      },
      [&](auto width, int k, int i) {
        constexpr int W = decltype(width)::value;
        float hi[W], lo[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const ff2 v = apply<OP>(x[k][0][e], x[k][1][e],
                                  x[k][kN == 4 ? 2 : 0][e],
                                  x[k][kN == 4 ? 3 : 0][e]);
          hi[e] = v.hi;
          lo[e] = v.lo;
        }
        ffstream::store<W>(t.out_hi + i, hi);
        ffstream::store<W>(t.out_lo + i, lo);
      });
}

template <int OP>
int launch_strided(const Planes& t, int grid, cudaStream_t stream) {
  elementwise_kernel<OP><<<grid, 256, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

template <int OP, int VEC>
int launch_flat(const Planes& t, int scalars, cudaStream_t stream) {
  const int grid = ffstream::stream_grid(t.rows * t.cols, VEC);
  flat_kernel<OP, VEC><<<grid, ffstream::kThreads, 0, stream>>>(t, scalars);
  return static_cast<int>(cudaGetLastError());
}

template <int OP>
int launch_flat(const Planes& t, int scalars, int vector,
                cudaStream_t stream) {
  return vector ? launch_flat<OP, ffstream::kVec>(t, scalars, stream)
                : launch_flat<OP, 1>(t, scalars, stream);
}

}  // namespace

// The size of struct Planes, which the Python wrapper mirrors.
extern "C" int ff_elementwise_planes_bytes() { return sizeof(Planes); }

// planes: a struct Planes (op, operand planes, outputs) in host memory,
// copied into the launch parameters; the strided path.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_elementwise_f32(const void* planes, cudaStream_t stream) {
  const Planes& t = *static_cast<const Planes*>(planes);
  const long long n = t.rows * t.cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 16, &grid)) return err;
  switch (t.op) {
    case ADD22: return launch_strided<ADD22>(t, grid, stream);
    case MUL22: return launch_strided<MUL22>(t, grid, stream);
    case DIV22: return launch_strided<DIV22>(t, grid, stream);
    case SQRT22: return launch_strided<SQRT22>(t, grid, stream);
    case TWO_PROD: return launch_strided<TWO_PROD>(t, grid, stream);
    case TWO_SUM: return launch_strided<TWO_SUM>(t, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The flat path over the same struct Planes: bit p of `scalars` marks
// operand p a scalar, every other operand dense at the output's shape;
// vector != 0: 16-byte accesses (every dense operand and both outputs
// 16-byte aligned), else 4-byte ones.  rows * cols < 2^30.
extern "C" int ff_elementwise_flat_f32(const void* planes, int scalars,
                                       int vector, cudaStream_t stream) {
  const Planes& t = *static_cast<const Planes*>(planes);
  const long long n = t.rows * t.cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (n >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  switch (t.op) {
    case ADD22: return launch_flat<ADD22>(t, scalars, vector, stream);
    case MUL22: return launch_flat<MUL22>(t, scalars, vector, stream);
    case DIV22: return launch_flat<DIV22>(t, scalars, vector, stream);
    case SQRT22: return launch_flat<SQRT22>(t, scalars, vector, stream);
    case TWO_PROD: return launch_flat<TWO_PROD>(t, scalars, vector, stream);
    case TWO_SUM: return launch_flat<TWO_SUM>(t, scalars, vector, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
