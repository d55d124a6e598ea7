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
// Design: one thread per output element in a grid-stride loop (a few
// blocks of 256 threads per SM, enough loads in flight to keep HBM busy),
// with each operand plane read through its (row, column) strides
// (ff_planes.cuh): stride 0 takes the place of the BlockSpec pinning, and
// there is no padding, so the ragged edge needs no mask beyond the loop
// bound.  The block shape of the TPU kernel has no counterpart here: the
// wrapper validates it and the launch does not depend on it.  TwoProd is
// the Dekker split (ffk::two_prod), as the reference kernel's
// (src/repro/kernels/eft.py): where the split overflows (|x| > 2^115) the
// FMA form would give other bits.  Each element is the explicitly rounded
// op sequence of its plain version (kernels/ff_elementwise.py
// elementwise_plain): its bits.

#include "ff_eft.cuh"
#include "ff_planes.cuh"

namespace {

using ffk::ff2;
using ffk::Planes;

// Same order as EW_OPS in kernels/ff_elementwise.py.
enum Op : int { ADD22, MUL22, DIV22, SQRT22, TWO_PROD, TWO_SUM };

template <int OP>
__global__ void __launch_bounds__(256)
elementwise_kernel(const __grid_constant__ Planes t) {
  ffk::for_each_element(t, [&](long long i, auto r, auto c) {
    using namespace ffk;
    const float a = load(t, 0, r, c), b = load(t, 1, r, c);
    ff2 v;
    if constexpr (OP == ADD22) {
      v = add22({a, b}, {load(t, 2, r, c), load(t, 3, r, c)});
    } else if constexpr (OP == MUL22) {
      v = mul22({a, b}, {load(t, 2, r, c), load(t, 3, r, c)});
    } else if constexpr (OP == DIV22) {
      v = div22({a, b}, {load(t, 2, r, c), load(t, 3, r, c)});
    } else if constexpr (OP == SQRT22) {
      v = sqrt22({a, b});
    } else if constexpr (OP == TWO_PROD) {
      v = two_prod(a, b);
    } else {
      v = two_sum(a, b);
    }
    t.out_hi[i] = v.hi;
    t.out_lo[i] = v.lo;
  });
}

}  // namespace

// The size of struct Planes, which the Python wrapper mirrors.
extern "C" int ff_elementwise_planes_bytes() { return sizeof(Planes); }

// planes: a struct Planes (op, operand planes, outputs) in host memory,
// copied into the launch parameters.  Returns the CUDA error of the launch
// (0 on success).
extern "C" int ff_elementwise_f32(const void* planes, cudaStream_t stream) {
  const Planes& t = *static_cast<const Planes*>(planes);
  const long long n = t.rows * t.cols;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 16, &grid)) return err;
  switch (t.op) {
    case ADD22: elementwise_kernel<ADD22><<<grid, 256, 0, stream>>>(t); break;
    case MUL22: elementwise_kernel<MUL22><<<grid, 256, 0, stream>>>(t); break;
    case DIV22: elementwise_kernel<DIV22><<<grid, 256, 0, stream>>>(t); break;
    case SQRT22:
      elementwise_kernel<SQRT22><<<grid, 256, 0, stream>>>(t);
      break;
    case TWO_PROD:
      elementwise_kernel<TWO_PROD><<<grid, 256, 0, stream>>>(t);
      break;
    case TWO_SUM:
      elementwise_kernel<TWO_SUM><<<grid, 256, 0, stream>>>(t);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
