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
// thousands (erf's series: 16 alternating and 59 positive terms, each a
// Mul22, one or two Div22 by an integer and an Add22): 30-300
// instructions per byte, far above the ~10 per byte at which the H100's
// memory keeps up, so the instruction rate bounds every function.
//
// Design: one kernel per function (a template instance: each carries only its
// own live set).  The device twins of ff_eft.cuh branch where the reference
// selects, so an element runs only the branch it takes (tanh: the identity,
// the Maclaurin kernel or the expm1 form, by tanh_band).  Eight functions run
// one thread per element in a grid-stride loop over strided operand planes
// (ff_planes.cuh): their branches are short.  For tanh the band sort below is
// faster on mixed bands (x uniform in (-1, 1)) but more than 5% slower on
// band-pure input, so tanh stays in this loop
// (repro_torch.benchmarks.math_variants "tanh band sort").  exp, expm1,
// log, log1p, sigmoid, silu and pow run each TwoProd as a multiply and an
// FMA (exp22_fmapath, expm122_fmapath, log22_fmapath, log1p22_fma,
// sigmoid22_fma, silu22_fma and pow22_fma, ff_eft.cuh) where one test an
// element proves Dekker's TwoProd exact (exp's reduced argument, log's atanh
// argument, the products whose low limb reaches the output, pow's l b), and
// exp22 / expm122 / log22 / log1p22 / sigmoid22 / silu22 / pow22 themselves
// elsewhere (out of line but log22 and log1p22, whose call would cost
// registers); on contiguous planes they take a flat index (kFlat).
// erf and gelu branch into series of very different lengths (erf22's bands:
// the alternating series on |x| <= 1, the positive series to 4, the
// asymptotic form beyond), and a warp whose elements straddle a band edge
// would run two series.  Their kernel (band_kernel) takes one tile of kTile
// elements a block: it stages the tile's limbs in shared memory, classifies
// each element by the band it takes (erf_band; gelu_band, on gelu22's own x /
// sqrt2), ranks it within its band by warp ballots and a block prefix of the
// warps' counts, and writes the tile's slots into one list, band by band, the
// costliest first.  Each warp then evaluates 32 consecutive entries of the
// list, so all but the warps at the two or three band edges of a tile run one
// series, and writes each result back into its element's slot; the tile
// leaves in coalesced stores (on a mixed input 1.7x faster than one thread an
// element; 5-12% slower on a tile of one band).  Inside the series every
// division is by an integer and exact without the IEEE division (div22_int /
// div22_odd, ff_eft.cuh): a multiply by RN(1/d) and two FMAs, no MUFU, FCHK
// or slow path.  The 16 small-band terms are unrolled, so their divisors fold
// to immediates; the 59 mid-band terms are unrolled by 4 with RN(1/(2n+1))
// from the constant table (fully unrolled, ~40 KB of instructions slow mixed
// tiles ~35%).  The paths off the series' range (div22 beyond 2^100, a lo
// limb larger than hi) stay out of line, where their code costs no
// instruction fetch.  The effect of each choice is measured by
// repro_torch.benchmarks.math_variants.  ~64 registers, no spills.  Each
// element runs erf22 / gelu22 itself, so it is its plain version's bits
// (kernels/ff_math.py math_elementwise_plain: the same op sequences); -Xptxas
// -v in build/.../libff_math.log gives each kernel's registers and spills.

#include <utility>

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
  if constexpr (OP == EXP) return exp22_fmapath(h, l);
  else if constexpr (OP == EXPM1) return expm122_fmapath(h, l);
  else if constexpr (OP == LOG) return log22_fmapath(h, l);
  else if constexpr (OP == LOG1P) return log1p22_fma(h, l);
  else if constexpr (OP == TANH) return tanh22(h, l);
  else if constexpr (OP == SIGMOID) return sigmoid22_fma(h, l);
  else if constexpr (OP == ERF) return erf22(h, l);
  else if constexpr (OP == GELU) return gelu22(h, l);
  else if constexpr (OP == SILU) return silu22_fma(h, l);
  else return pow22_fma(h, l, bh, bl);
}

// exp, expm1, log, log1p, sigmoid, silu and pow on contiguous operand
// planes (the silu gate of serving): a flat index, without
// for_each_element's division by the column count and its strided
// addresses.
template <int OP>
constexpr bool kFlat = OP == EXP || OP == EXPM1 || OP == LOG ||
    OP == SIGMOID || OP == SILU || OP == LOG1P || OP == POW;

// Every operand plane of OP (pow's four, two otherwise) is row-major and
// dense: a broadcast plane (stride 0) is not.
template <int OP>
__device__ __forceinline__ bool contiguous(const Planes& t) {
  const bool x = t.cs[0] == 1 && t.cs[1] == 1 && t.rs[0] == t.cols &&
                 t.rs[1] == t.cols;
  if constexpr (OP == POW)
    return x && t.cs[2] == 1 && t.cs[3] == 1 && t.rs[2] == t.cols &&
           t.rs[3] == t.cols;
  return x;
}

// Element i of contiguous operand planes.
template <int OP>
__device__ __forceinline__ ff2 flat_apply(const Planes& t, long long i) {
  if constexpr (OP == POW)
    return apply<OP>(t.in[0][i], t.in[1][i], t.in[2][i], t.in[3][i]);
  else
    return apply<OP>(t.in[0][i], t.in[1][i], 0.0f, 0.0f);
}

template <int OP>
__global__ void __launch_bounds__(256)
math_kernel(const __grid_constant__ Planes t) {
  if constexpr (kFlat<OP>) {
    if (contiguous<OP>(t)) {
      const long long n = t.rows * t.cols;
      const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
      for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
           i < n; i += stride) {
        const ff2 v = flat_apply<OP>(t, i);
        t.out_hi[i] = v.hi;
        t.out_lo[i] = v.lo;
      }
      return;
    }
  }
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

// The band-sorted kernel of erf and gelu.
constexpr int kThreads = 256;
constexpr int kPer = 8;                      // elements a thread stages
constexpr int kTile = kThreads * kPer;       // 2048: 16 KB of limbs
constexpr int kWarps = kThreads / 32;
constexpr int kBands = ffk::kErfBands;

template <int OP>
__device__ __forceinline__ int band_of(float h, float l) {
  if constexpr (OP == ERF) return ffk::erf_band(h);
  else return ffk::gelu_band(h, l);
}

template <int OP>
__global__ void __launch_bounds__(kThreads)
band_kernel(const __grid_constant__ Planes t) {
  __shared__ float limb[2][kTile];           // the tile's limbs, then results
  __shared__ unsigned short order[kTile];    // tile slots, band by band
  __shared__ int count[kWarps][kBands];      // elements per warp and band
  __shared__ int first[kWarps][kBands];      // a warp's first list entry
  const long long n = t.rows * t.cols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile; base < n;
       base += static_cast<long long>(gridDim.x) * kTile) {
    const int m = static_cast<int>(n - base < kTile ? n - base : kTile);
    int band[kPer], rank[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + tid;
      band[k] = kBands;                      // past the edge: no band
      rank[k] = 0;
      if (j < m) {
        long long r, c;
        if (n < (1LL << 31)) {               // 32-bit index arithmetic
          const int i = static_cast<int>(base) + j;
          const int cols = static_cast<int>(t.cols), ri = i / cols;
          r = ri;
          c = i - ri * cols;
        } else {
          const long long i = base + j;
          r = i / t.cols;
          c = i - r * t.cols;
        }
        const float h = ffk::load(t, 0, r, c), l = ffk::load(t, 1, r, c);
        limb[0][j] = h;
        limb[1][j] = l;
        band[k] = band_of<OP>(h, l);
      }
    }
    // rank within the warp, band by band, in (k, lane) order
#pragma unroll
    for (int b = 0; b < kBands; ++b) {
      int run = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const unsigned in = __ballot_sync(0xffffffffu, band[k] == b);
        if (band[k] == b) rank[k] = run + __popc(in & below);
        run += __popc(in);
      }
      if (lane == 0) count[warp][b] = run;
    }
    __syncthreads();
    // list entries before the warp's in band `lane`: the earlier bands,
    // then the earlier warps' share of it
    if (lane < kBands) {
      int s = 0;
      for (int b = 0; b < lane; ++b)
        for (int w = 0; w < kWarps; ++w) s += count[w][b];
      for (int w = 0; w < warp; ++w) s += count[w][lane];
      first[warp][lane] = s;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (band[k] < kBands)
        order[first[warp][band[k]] + rank[k]] = k * kThreads + tid;
    __syncthreads();
    // 32 consecutive entries a warp: one band but at a band boundary
    for (int e = tid; e < m; e += kThreads) {
      const int j = order[e];
      const ff2 v = apply<OP>(limb[0][j], limb[1][j], 0.0f, 0.0f);
      limb[0][j] = v.hi;
      limb[1][j] = v.lo;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = k * kThreads + tid;
      if (j < m) {
        t.out_hi[base + j] = limb[0][j];
        t.out_lo[base + j] = limb[1][j];
      }
    }
    __syncthreads();                         // the tile's slots are free
  }
}

template <int OP>
int launch(const Planes& t, int grid, cudaStream_t stream) {
  math_kernel<OP><<<grid, 256, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// One block a tile: the hardware hands tiles to SMs as blocks finish, so
// tiles of unequal cost (their band mix) balance across the card.
template <int OP>
int launch_bands(const Planes& t, long long n, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  const int grid = static_cast<int>(tiles < 0x7fffffff ? tiles : 0x7fffffff);
  band_kernel<OP><<<grid, kThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The exact integer division against the IEEE division on the card.

// The divisors of the erf series: n = 1..16, then the odd 2n + 1 to 119.
constexpr int kNumDivisors = 68;
__host__ __device__ constexpr int divisor(int i) {
  return i < 16 ? i + 1 : 17 + 2 * (i - 16);
}

__device__ __forceinline__ bool same_bits(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y) || (x != x && y != y);
}

// The mismatches of div_int against __fdiv_rn and of div22_int against
// div22(., {d, 0}) at one dividend (hi, lo), also of their bounded forms
// where the dividend is finite and below kSplitSafe: d an immediate (as in
// an unrolled series) and d a register (a rolled one).
template <int D>
__device__ __forceinline__ int2 div_mismatch(float hi, float lo, int d) {
  int2 s = {0, 0};
  const ff2 want = ffk::div22({hi, lo}, {static_cast<float>(D), 0.0f});
  const float q = __fdiv_rn(hi, static_cast<float>(D));
  // the bounded forms (erf's series) where their preconditions hold
  const bool finite = fabsf(hi) < ffk::kSplitSafe && fabsf(lo) < ffk::inf32();
  const auto tally = [&](int dd) {
    const ff2 got = ffk::div22_int({hi, lo}, dd);
    s.x += !same_bits(ffk::div_int(hi, dd), q);
    s.y += !(same_bits(got.hi, want.hi) && same_bits(got.lo, want.lo));
    if (finite) {
      const ff2 b = ffk::div22_int<true>({hi, lo}, dd);
      s.x += !same_bits(ffk::div_int<true>(hi, dd), q);
      s.y += !(same_bits(b.hi, want.hi) && same_bits(b.lo, want.lo));
    }
    if (dd & 1 && dd > 1) {          // the odd forms, as erf's mid series
      const float df = static_cast<float>(dd), zh = ffk::kRecip[dd];
      const ff2 o = ffk::div22_odd({hi, lo}, df, zh);
      s.x += !same_bits(ffk::div_odd(hi, df, zh), q);
      s.y += !(same_bits(o.hi, want.hi) && same_bits(o.lo, want.lo));
      if (finite) {
        const ff2 b = ffk::div22_odd<true>({hi, lo}, df, zh);
        s.x += !same_bits(ffk::div_odd<true>(hi, df, zh), q);
        s.y += !(same_bits(b.hi, want.hi) && same_bits(b.lo, want.lo));
      }
    }
  };
  tally(D);
  tally(d);
  return s;
}

template <int... I>
__device__ __forceinline__ int2 div_mismatches(
    float hi, float lo, const int* d, std::integer_sequence<int, I...>) {
  int2 s = {0, 0};
  const auto tally = [&](int2 m) {
    s.x += m.x;
    s.y += m.y;
  };
  (tally(div_mismatch<divisor(I)>(hi, lo, d[I])), ...);
  return s;
}

// Every f32 bit pattern as hi; lo +0, -0 or hi * 2^-25 * (1 + k/128),
// k from the bits, of either sign.  bad[0] counts div_int, bad[1]
// div22_int; d holds the divisors, read at run time.
__global__ void div_check_kernel(unsigned long long* bad, const int* d) {
  unsigned long long nx = 0, ny = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       i < (1ull << 32); i += stride) {
    const unsigned bits = static_cast<unsigned>(i);
    const float hi = __uint_as_float(bits);
    const unsigned h = bits * 2654435761u;
    const unsigned kind = h >> 30;
    const float scale = (1.0f + static_cast<float>((h >> 8) & 127) *
                                    0x1p-7f) * 0x1p-25f;
    const float lo = kind == 0 ? 0.0f
                     : kind == 1 ? -0.0f
                     : ffk::mul(hi, (kind == 2 ? scale : -scale));
    const int2 s = div_mismatches(
        hi, lo, d, std::make_integer_sequence<int, kNumDivisors>{});
    nx += s.x;
    ny += s.y;
  }
  if (nx) atomicAdd(bad, nx);
  if (ny) atomicAdd(bad + 1, ny);
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
  if (t.op == ERF) return launch_bands<ERF>(t, n, stream);
  if (t.op == GELU) return launch_bands<GELU>(t, n, stream);
  int grid = 0;
  if (int err = ffk::elementwise_grid(n, 256, 8, &grid)) return err;
  switch (t.op) {
    case EXP: return launch<EXP>(t, grid, stream);
    case EXPM1: return launch<EXPM1>(t, grid, stream);
    case LOG: return launch<LOG>(t, grid, stream);
    case LOG1P: return launch<LOG1P>(t, grid, stream);
    case TANH: return launch<TANH>(t, grid, stream);
    case SIGMOID: return launch<SIGMOID>(t, grid, stream);
    case SILU: return launch<SILU>(t, grid, stream);
    case POW: return launch<POW>(t, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The division check: bad, two zeroed unsigned long longs on the card,
// receives the mismatch counts of div_int (against __fdiv_rn) and of
// div22_int (against div22) over every f32 dividend and the 68 divisors
// of the erf series; divisors, the 68 ints 1..16, 17, 19, ..., 119 on the
// card, are read at run time (the rolled path).  Returns the CUDA error of
// the launch.
extern "C" int ff_math_div_check(void* bad, const void* divisors,
                                 cudaStream_t stream) {
  int grid = 0;
  if (int err = ffk::elementwise_grid(1ll << 32, 256, 8, &grid)) return err;
  div_check_kernel<<<grid, 256, 0, stream>>>(
      static_cast<unsigned long long*>(bad),
      static_cast<const int*>(divisors));
  return static_cast<int>(cudaGetLastError());
}
