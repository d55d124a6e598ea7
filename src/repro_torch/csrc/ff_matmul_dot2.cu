// Paper-faithful FF matrix product (Dot2 products, Dot3 accumulation).
//
// Replaces the TPU kernel src/repro/kernels/ff_matmul.py::ff_matmul_dot2
// (_ff_matmul_dot2_kernel).  Per output, K runs in slabs of VEC products:
//   * each product exactly, with ff_eft.cuh's two_prod_fma (a multiply
//     and an explicit FMA: on normal-range operands the same product and
//     error as the Dekker TwoProd of the plain version and the reference);
//   * the slab's pairwise compensated tree (repro_torch.core.transforms.
//     pairwise_sum_compensated): each level pairs entry t with t + half by
//     TwoSum, an odd last entry carries over, and the level's TwoSum errors
//     are summed from +0 in order into err, which starts as the in-order
//     sum of the VEC product errors;
//   * the (s, c, cc) cascade: (s, se) = TwoSum(s, slab),
//     (c, ce) = TwoSum(c, se + err), cc += ce;
//   * at the end, Fast2Sum(s, c + cc).
// Past the product, this is the op sequence of the plain version
// (core/ffmatmul.matmul_dot2 with chunk = VEC), and the product's error is
// exact on both sides, so the two agree to the bit; a short last slab
// reads zeros, as the plain version pads it.  The cascade runs on across
// the TPU kernel's K-blocks, so bk changes no bits (VEC does).  Every add,
// multiply, FMA and TwoSum is an explicitly rounded intrinsic.
//
// What bounds it on this card: f32 issue slots.  Each product costs about
// 11.25 f32 instructions at VEC = 8 (the product and its error 2, the
// error's add, the tree's TwoSums and adds ~6.5, the cascade ~1.6), and an
// SM sub-partition issues one warp instruction a cycle, which its 32 f32
// lanes take one a cycle: so every other instruction (a shared-memory
// load, an address, a branch) takes an f32 instruction's slot.  The
// design spends as few of those as it can around the fixed arithmetic:
//   * register tiles: a thread owns RM x RN outputs, each with its own
//     (s, c, cc); per slab it loads its RN columns of B (VEC values each,
//     held for the slab) and, row by row, the row's VEC values of A, with
//     8- and 16-byte shared loads, and reuses each across the tile.  A's
//     tile is stored row by row (K contiguous), B's k by k (N contiguous),
//     so a thread's values are contiguous;
//   * interleaved chains: IL outputs of a row run their products, tree
//     levels and cascades side by side, so their 4-cycle dependency chains
//     overlap inside one thread: the 4 x 4 tile's ~184 registers leave
//     one block (8 warps) an SM, and capped at two blocks it spills;
//   * staged operands: a ring of STAGES K-tiles in shared memory, filled
//     with cp.async (4-byte copies through the operands' strides, zero
//     filled past M, N and K), so the loads of the next tiles are in
//     flight while one tile computes; one barrier per tile; the loaders'
//     addresses are hoisted out of the K loop.
// What it cannot do, for the bits' sake: no split of K (the cascade runs
// in order across all of K) and no tensor cores (each product's rounding
// and error are per element, and the tree's order is fixed).  Operands
// are read through their strides, so transposed views need no copy.
// The effect of each choice is measured by
// repro_torch.benchmarks.dot2_variants; -Xptxas -v in
// build/.../libff_matmul_dot2.log gives each instance's registers and
// spills.

#include "ff_eft.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTx = 16, kTy = 16;   // threads along N and along M

// RM x RN outputs a thread, IL of them interleaved, STAGES K-tiles in the
// ring (1: synchronous staging), MINB blocks an SM for the register cap.
template <int RM_, int RN_, int IL_, int STAGES_, int MINB_>
struct Config {
  static constexpr int RM = RM_, RN = RN_, IL = IL_, STAGES = STAGES_,
                       MINB = MINB_;
  static_assert(RN % IL == 0, "IL must divide RN");
};
using Shipped = Config<4, 4, 2, 3, 1>;

// The tile shapes of one instance.  A K-tile holds whole slabs and a
// multiple of 8 values of K (so the loaders' shares are whole).
template <int VEC, typename C>
struct Tile {
  static constexpr int kBM = kTy * C::RM, kBN = kTx * C::RN;
  static constexpr int kTk = 32 % VEC == 0 ? 32 : 8 * VEC;
  static constexpr int kSlabs = kTk / VEC;
  static constexpr int kPitchA = kTk + 4;           // As[m][k], padded rows
  static constexpr int kStageA = kBM * kPitchA;
  static constexpr int kStage = kStageA + kTk * kBN;   // + Bs[k][n]
  static constexpr int kLoadsA = kBM * kTk / kThreads;
  static constexpr int kLoadsB = kTk * kBN / kThreads;
  static constexpr size_t kSmem = sizeof(float) * C::STAGES * kStage;
  static_assert(kLoadsA * kThreads == kBM * kTk, "A tile share");
  static_assert(kLoadsB * kThreads == kTk * kBN, "B tile share");
  static_assert(kThreads % kBN == 0, "B loader mapping");
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VEC contiguous floats of shared memory, in 16- or 8-byte loads where the
// slab's offset allows.
template <int VEC>
__device__ __forceinline__ void load_row(float (&v)[VEC], const float* p) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (VEC % 2 == 0) {
#pragma unroll
    for (int q = 0; q < VEC / 2; ++q) {
      const float2 t = reinterpret_cast<const float2*>(p)[q];
      v[2 * q] = t.x;
      v[2 * q + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = p[q];
  }
}

// One level of the pairwise tree over p[.][0..W) of IL outputs side by
// side, then the next level.
template <int W, int VEC, int IL>
struct Tree {
  static __device__ __forceinline__ void run(float (&p)[IL][VEC],
                                             float (&err)[IL]) {
    using namespace ffk;
    constexpr int H = W / 2;
    float esum[IL];
#pragma unroll
    for (int q = 0; q < IL; ++q) esum[q] = 0.0f;
#pragma unroll
    for (int t = 0; t < H; ++t) {
#pragma unroll
      for (int q = 0; q < IL; ++q) {
        const ff2 r = two_sum(p[q][t], p[q][t + H]);
        p[q][t] = r.hi;
        esum[q] = add(esum[q], r.lo);
      }
    }
#pragma unroll
    for (int q = 0; q < IL; ++q) {
      err[q] = add(err[q], esum[q]);
      if (W & 1) p[q][H] = p[q][W - 1];
    }
    Tree<H + (W & 1), VEC, IL>::run(p, err);
  }
};

template <int VEC, int IL>
struct Tree<1, VEC, IL> {
  static __device__ __forceinline__ void run(float (&)[IL][VEC],
                                             float (&)[IL]) {}
};

template <int VEC, typename C>
__global__ void __launch_bounds__(kThreads, C::MINB)
dot2_kernel(const float* __restrict__ a, long long sa0, long long sa1,
            const float* __restrict__ b, long long sb0, long long sb1,
            float* __restrict__ out_hi, float* __restrict__ out_lo, int M,
            int N, int K) {
  using namespace ffk;
  using T = Tile<VEC, C>;
  constexpr int RM = C::RM, RN = C::RN, IL = C::IL, S = C::STAGES;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;
  const int m0 = blockIdx.y * T::kBM, n0 = blockIdx.x * T::kBN;
  const int kpad = (K + VEC - 1) / VEC * VEC;   // whole slabs
  const int ntiles = (kpad + T::kTk - 1) / T::kTk;

  // The loaders.  B: column nb of the tile, rows kb0 + r * kStepB.  A
  // (where a warp's share is one row of the K-tile): column ka, rows
  // ma0 + r * kStepA; else each copy's place from its index.
  constexpr int kStepB = kThreads / T::kBN;
  const int nb = tid % T::kBN, kb0 = tid / T::kBN;
  const bool col_ok = n0 + nb < N;
  const float* const pb = b + static_cast<long long>(kb0) * sb0 +
                          static_cast<long long>(n0 + nb) * sb1;
  const long long stepb = kStepB * sb0;
  constexpr bool kRowsA = kThreads % T::kTk == 0;
  constexpr int kStepA = kRowsA ? kThreads / T::kTk : 0;
  const int ka = tid % T::kTk, ma0 = tid / T::kTk;
  const int rows_a = M - m0 - ma0;           // rows left from ma0
  const float* const pa = a + static_cast<long long>(m0 + ma0) * sa0 +
                          static_cast<long long>(ka) * sa1;
  const long long stepa = kStepA * sa0;

  auto load_tile = [&](int stage, int kt) {
    float* const sA = smem + stage * T::kStage;
    float* const sB = sA + T::kStageA;
    if constexpr (kRowsA) {
      const bool k_ok = kt + ka < K;
      const float* p = pa + kt * sa1;
#pragma unroll
      for (int r = 0; r < T::kLoadsA; ++r) {
        const bool ok = k_ok && r * kStepA < rows_a;
        cp_async4(sA + (ma0 + r * kStepA) * T::kPitchA + ka, ok ? p : a, ok);
        p += stepa;
      }
    } else {
#pragma unroll
      for (int r = 0; r < T::kLoadsA; ++r) {
        const int l = tid + r * kThreads, mm = l / T::kTk, kk = l % T::kTk;
        const bool ok = m0 + mm < M && kt + kk < K;
        const float* p = a + static_cast<long long>(m0 + mm) * sa0 +
                         static_cast<long long>(kt + kk) * sa1;
        cp_async4(sA + mm * T::kPitchA + kk, ok ? p : a, ok);
      }
    }
    const float* p = pb + kt * sb0;
#pragma unroll
    for (int r = 0; r < T::kLoadsB; ++r) {
      const bool ok = col_ok && kt + kb0 + r * kStepB < K;
      cp_async4(sB + (kb0 + r * kStepB) * T::kBN + nb, ok ? p : b, ok);
      p += stepb;
    }
  };

  float s[RM * RN], c[RM * RN], cc[RM * RN];
#pragma unroll
  for (int o = 0; o < RM * RN; ++o) s[o] = c[o] = cc[o] = 0.0f;

  // One K-tile from shared memory: slab by slab, B's RN columns for the
  // slab, then row by row A's VEC values and the row's RN outputs, IL at
  // a time.
  auto compute_tile = [&](int stage, int kt) {
    const float* const sA = smem + stage * T::kStage + ty * RM * T::kPitchA;
    const float* const sB = smem + stage * T::kStage + T::kStageA + tx * RN;
#pragma unroll
    for (int sl = 0; sl < T::kSlabs; ++sl) {
      if (kt + sl * VEC >= kpad) break;     // past the last slab
      float bv[VEC][RN];
#pragma unroll
      for (int v = 0; v < VEC; ++v) load_row<RN>(bv[v], sB + (sl * VEC + v) * T::kBN);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float av[VEC];
        load_row<VEC>(av, sA + i * T::kPitchA + sl * VEC);
#pragma unroll
        for (int j0 = 0; j0 < RN; j0 += IL) {
          float p[IL][VEC], err[IL];
#pragma unroll
          for (int q = 0; q < IL; ++q) err[q] = 0.0f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
#pragma unroll
            for (int q = 0; q < IL; ++q) {
              const ff2 t = two_prod_fma(av[v], bv[v][j0 + q]);
              p[q][v] = t.hi;
              err[q] = add(err[q], t.lo);
            }
          }
          Tree<VEC, VEC, IL>::run(p, err);
#pragma unroll
          for (int q = 0; q < IL; ++q) {
            const int o = i * RN + j0 + q;
            const ff2 u = two_sum(s[o], p[q][0]);
            const ff2 w = two_sum(c[o], add(u.lo, err[q]));
            s[o] = u.hi;
            c[o] = w.hi;
            cc[o] = add(cc[o], w.lo);
          }
        }
      }
    }
  };

  if constexpr (S == 1) {                   // synchronous staging
    for (int t = 0; t < ntiles; ++t) {
      load_tile(0, t * T::kTk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      compute_tile(0, t * T::kTk);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < ntiles) load_tile(t, t * T::kTk);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<S - 2>();               // tile t has landed (this thread)
      __syncthreads();                      // ... for all, and t - 1 is done
      const int tn = t + S - 1;
      if (tn < ntiles) load_tile(tn % S, tn * T::kTk);
      cp_async_commit();
      compute_tile(t % S, t * T::kTk);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j, o = i * RN + j;
      if (m < M && n < N) {
        const ff2 r = fast_two_sum(s[o], add(c[o], cc[o]));
        out_hi[static_cast<long long>(m) * N + n] = r.hi;
        out_lo[static_cast<long long>(m) * N + n] = r.lo;
      }
    }
  }
}

template <int VEC>
int launch(const float* a, long long sa0, long long sa1, const float* b,
           long long sb0, long long sb1, float* hi, float* lo, int M, int N,
           int K, cudaStream_t stream) {
  using T = Tile<VEC, Shipped>;
  auto kernel = dot2_kernel<VEC, Shipped>;
  // above 48 KB only by this attribute (per device: set at every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long gy = (static_cast<long long>(M) + T::kBM - 1) / T::kBM;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + T::kBN - 1) / T::kBN, static_cast<unsigned>(gy));
  kernel<<<grid, kThreads, T::kSmem, stream>>>(a, sa0, sa1, b, sb0, sb1, hi,
                                               lo, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) and b (K, N) f32 with element strides (sa0, sa1), (sb0, sb1);
// out_hi, out_lo (M, N) contiguous; vec in 1..8 (= DOT2_MAX_VEC in
// kernels/ff_matmul.py).  Returns the CUDA error of the launch (0 on
// success).
extern "C" int ff_matmul_dot2_f32(const float* a, long long sa0,
                                  long long sa1, const float* b,
                                  long long sb0, long long sb1, float* out_hi,
                                  float* out_lo, int M, int N, int K, int vec,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  switch (vec) {
    case 1: return launch<1>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 2: return launch<2>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 3: return launch<3>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 4: return launch<4>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 5: return launch<5>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 6: return launch<6>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 7: return launch<7>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    case 8: return launch<8>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
