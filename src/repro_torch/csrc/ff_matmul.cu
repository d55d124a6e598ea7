// FF matrix product that folds f32 block products into a float-float
// accumulator: the hybrid scheme.  (The Ozaki slice-pair scheme runs on the
// tensor cores: ff_matmul_ozaki.cu.)
//
// Replaces the TPU kernel src/repro/kernels/ff_matmul.py::ff_matmul
// (_ff_matmul_kernel): for each K-block of bk, the f32 block product
// p = A[:, k-block] @ B[k-block, :], folded once into (hi, lo):
// TwoSum(hi, p), lo' = sl + lo, Fast2Sum (Add212).
//
// The block products multiply-add with explicit __fmaf_rn (the build's
// --fmad=false forbids contraction elsewhere): FMA sets the f32 rounding of
// each block product, which has no reference bits (the TPU sums it in
// 6-pass bf16, cuBLAS in its own order).  The folds use ff_eft.cuh's
// explicitly rounded add212.
//
// Bits.  Each output's K-block product is one __fmaf_rn chain from +0 over
// the K-block's k in order, and the block products fold into (hi, lo) in
// K-block order.  Nothing else enters an output, so every tiling, staging
// and split below gives the same bits, as long as no chain is split or
// reassociated and none runs past its K-block's end (a multiply-add of
// zero-filled operands would turn a -0 sum into +0): a K-block's last,
// partial tile runs only its own k.  Only the loaders depend on the
// operands' layout.  csrc/ff_matmul_hybrid_check.cu keeps the earlier
// design (64 x 64 tiles, 4 x 4 outputs a thread, synchronous staging), and
// chip_smoke.py holds this kernel to it bit for bit.
//
// What bounds it on this card: M N K multiply-adds, one FFMA each, on 132
// SMs x 128 f32 lanes, plus the fold's 10 instructions per output and
// K-block; the operands are read once per output tile, so at the shapes of
// the path it is bound by operations, not bytes.  The f32 products keep
// their IEEE rounding, so the tensor cores (TF32) are out.  Every
// instruction beside the FFMAs takes one of their issue slots; the design
// spends as few as it can:
//   * register tiles: a block of TY x TX = 16 x 8 threads computes a
//     128 x 64 output tile, each thread RM x RN = 8 x 8 outputs in 4-row and
//     4-column groups half a tile apart; a warp's threads are 4 rows by 8
//     columns.  A's shared tile is stored k-major (M contiguous), B's
//     N-contiguous, so each k costs a thread four 16-byte shared loads for
//     64 FFMAs;
//   * staged operands: a ring of STAGES = 3 K-tiles of depth TK = 16 in
//     shared memory, filled with cp.async while earlier tiles compute, one
//     barrier a tile, the loaders' addresses hoisted out of the K loop.
//     16-byte copies where an operand is contiguous along the tile's fast
//     axis (M for A, N for B) and 16-byte aligned; else 4-byte copies
//     through the strides (row-major A, the backward pass's transposed
//     views, N = 49155), with consecutive threads on the operand's
//     contiguous axis.  Rows are padded by 4 floats, so 4-byte copies along
//     k do not share a bank;
//   * the FF accumulator (hi, lo), touched once per K-block, lives in
//     dynamic shared memory (64 KB a block, one float2 an output, laid out
//     thread-fastest so a warp's accesses are consecutive): a thread holds
//     only its 64 block products, ~167 registers, and two blocks (8 warps)
//     fit an SM;
//   * filling the card: where the output tiles are fewer than two blocks an
//     SM, the wrapper (kernels/ff_matmul.py hybrid_plan) splits each tile's
//     K-blocks over several blocks, which write their block products to a
//     workspace (so they need no accumulator, and three fit an SM);
//     fold_kernel folds them in K-block order.
// Measured alternatives (repro_torch.benchmarks.hybrid_variants): the
// accumulator in registers or in the outputs, 128 x 128 tiles of 256
// threads, deeper or shallower tiles and rings.  -Xptxas -v in
// build/.../libff_matmul.log gives each instance's registers and spills.

#include <cstdint>

#include "ff_eft.cuh"
#include "ff_planes.cuh"

namespace {

// Where the FF accumulator lives (kAccSmem ships; the others are measured
// alternatives, repro_torch.benchmarks.hybrid_variants).
enum Acc : int { kAccRegs, kAccSmem, kAccOut };

// TX x TY threads, each RM x RN outputs; K-tiles of TK in a ring of STAGES
// (1: synchronous staging); the FF accumulator's place; MINB blocks an SM
// for the register cap; a warp's threads WTX along N by 32 / WTX along M.
template <int TX_, int TY_, int RM_, int RN_, int TK_, int STAGES_, int ACC_,
          int MINB_, int WTX_>
struct Config {
  static constexpr int TX = TX_, TY = TY_, RM = RM_, RN = RN_, TK = TK_,
                       STAGES = STAGES_, ACC = ACC_, MINB = MINB_,
                       WTX = WTX_;
  static constexpr int kThreads = TX * TY;
  static constexpr int BM = TY * RM, BN = TX * RN;
  static constexpr int PA = BM + 4, PB = BN + 4;   // As[k][m], Bs[k][n]
  static constexpr int kStage = TK * (PA + PB);
  static constexpr size_t kRing = sizeof(float) * STAGES * kStage;
  static constexpr size_t kSmem =
      kRing + (ACC == kAccSmem ? sizeof(float2) * kThreads * RM * RN : 0);
  static_assert(RM % 4 == 0 && RN % 4 == 0, "16-byte shared loads");
  static_assert(TX % WTX == 0 && 32 % WTX == 0 && TY % (32 / WTX) == 0,
                "warp layout");
};
using Shipped = Config<8, 16, 8, 8, 16, 3, 1, 2, 8>;   // 128 x 64

struct Operand {
  const float* p;
  long long s0, s1;             // element (r, c) at p[r * s0 + c * s1]
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's share of each K-tile: the tile s[k * P + w], k < TK, w < W
// (w along M for A, along N for B), of the operand element (w0 + w, k) at
// op[(w0 + w) * sw + k * sk].  VEC: one 16-byte copy of 4 consecutive w per
// copy; else 4-byte copies, consecutive threads along k (kfast) or along w.
// Set up once; load() issues one tile's copies.  A copy past the operand's
// ends reads 0 bytes: its address is never read (the zero fill is the
// copy's src-size).
template <bool VEC, int TK, int W, int P, int NT>
struct Loader {
  static constexpr int kCopies = VEC ? TK * W / 4 / NT : TK * W / NT;
  static_assert(kCopies * NT * (VEC ? 4 : 1) == TK * W, "tile share");
  static_assert(NT % TK == 0 && NT % W == 0 && NT % (W / 4) == 0,
                "loader mapping");
  const float* p;               // this thread's first element at k = 0
  long long sk, step;           // per k; per copy
  int k, w, dk, dw;             // its first element in the tile; per copy
  int wleft;                    // the operand's extent past w0

  __device__ __forceinline__ Loader(const float* op, long long sw,
                                    long long sk_, int w0, int extent,
                                    bool kfast, int tid) {
    if constexpr (VEC) {
      k = tid / (W / 4);
      w = tid % (W / 4) * 4;
      dk = NT / (W / 4);
      dw = 0;
    } else if (kfast) {
      k = tid % TK;
      w = tid / TK;
      dk = 0;
      dw = NT / TK;
    } else {
      w = tid % W;
      k = tid / W;
      dk = NT / W;
      dw = 0;
    }
    sk = sk_;
    p = op + static_cast<long long>(w0 + w) * sw +
        static_cast<long long>(k) * sk;
    step = dk * sk + dw * sw;
    wleft = extent - w0;
  }

  // The tile at kt of a K-block ending at kend; zero past both ends.
  __device__ __forceinline__ void load(float* s, int kt, int kend) const {
    const float* q = p + static_cast<long long>(kt) * sk;
    const int kleft = kend - kt;
#pragma unroll
    for (int r = 0; r < kCopies; ++r) {
      const int kk = k + r * dk, ww = w + r * dw;
      if constexpr (VEC) {
        const int n = min(max(wleft - ww, 0), 4);
        const int bytes = kk < kleft ? 4 * n : 0;
        cp_async16(s + kk * P + ww, q, bytes);
      } else {
        const bool ok = kk < kleft && ww < wleft;
        cp_async4(s + kk * P + ww, q, ok);
      }
      q += step;
    }
  }
};

// The tiles of one block, in order: each of its K-blocks [kb bk, kend) in
// tiles of TK from the K-block's start, the last one partial.
struct Cursor {
  int kb, kt, kend;
  __device__ __forceinline__ Cursor(int kb_, int bk, int K)
      : kb(kb_), kt(kb_ * bk), kend(min(kb_ * bk + bk, K)) {}
  template <int TK>
  __device__ __forceinline__ void advance(int bk, int K) {
    kt += TK;
    if (kt >= kend) {
      ++kb;
      kt = kb * bk;
      kend = min(kt + bk, K);
    }
  }
};

// acc[i][j] = fma(A[m_i, k], B[k, n_j], acc[i][j]) for one k of the tile:
// a thread's rows ty 4 + 4-groups BM / (RM / 4) apart, its columns the same.
template <typename C>
__device__ __forceinline__ void fma_k(const float* sA, const float* sB,
                                      float (&acc)[C::RM][C::RN]) {
  float a[C::RM], b[C::RN];
#pragma unroll
  for (int g = 0; g < C::RM / 4; ++g) {
    const float4 t =
        *reinterpret_cast<const float4*>(sA + g * (C::BM / (C::RM / 4)));
    a[4 * g] = t.x;
    a[4 * g + 1] = t.y;
    a[4 * g + 2] = t.z;
    a[4 * g + 3] = t.w;
  }
#pragma unroll
  for (int g = 0; g < C::RN / 4; ++g) {
    const float4 t =
        *reinterpret_cast<const float4*>(sB + g * (C::BN / (C::RN / 4)));
    b[4 * g] = t.x;
    b[4 * g + 1] = t.y;
    b[4 * g + 2] = t.z;
    b[4 * g + 3] = t.w;
  }
#pragma unroll
  for (int i = 0; i < C::RM; ++i) {
#pragma unroll
    for (int j = 0; j < C::RN; ++j) {
      acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
}

// The hybrid kernel.  Block (x, y, z): output tile (y, x) over the K-blocks
// [z kbs, (z + 1) kbs).  With ws null (no split) each K-block's product is
// folded into the FF accumulator and (hi, lo) is written at the end; else
// the products go to ws[kb][m][n] for fold_kernel.
template <typename C, bool VA, bool VB>
__global__ void __launch_bounds__(C::kThreads, C::MINB)
hybrid_kernel(Operand a, Operand b, float* __restrict__ out_hi,
              float* __restrict__ out_lo, float* __restrict__ ws, int M,
              int N, int K, int bk, int kbs, bool a_kfast, bool b_kfast) {
  using namespace ffk;
  constexpr int RM = C::RM, RN = C::RN, S = C::STAGES, TK = C::TK;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float2* const accs = reinterpret_cast<float2*>(smem + S * C::kStage);
  const int tid = threadIdx.x;
  // the thread's column and row groups: warps row-major over the block
  constexpr int WN = C::TX / C::WTX;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = warp % WN * C::WTX + lane % C::WTX;
  const int ty = warp / WN * (32 / C::WTX) + lane / C::WTX;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int nkb = (K + bk - 1) / bk;
  const int kb0 = blockIdx.z * kbs, kb1 = min(nkb, kb0 + kbs);
  // tiles of this block's K-blocks; only the last K-block may be short
  const int tpb = (bk + TK - 1) / TK;
  int ntiles = (kb1 - kb0) * tpb;
  if (kb1 == nkb && kb1 > kb0)
    ntiles -= tpb - (K - (nkb - 1) * bk + TK - 1) / TK;

  const Loader<VA, TK, C::BM, C::PA, C::kThreads> la(
      a.p, a.s0, a.s1, m0, M, a_kfast, tid);
  const Loader<VB, TK, C::BN, C::PB, C::kThreads> lb(
      b.p, b.s1, b.s0, n0, N, b_kfast, tid);
  auto load_tile = [&](int stage, const Cursor& c) {
    float* const sA = smem + stage * C::kStage;
    la.load(sA, c.kt, c.kend);
    lb.load(sA + TK * C::PA, c.kt, c.kend);
  };

  float p[RM][RN], hi[RM][RN], lo[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      p[i][j] = 0.0f;
      if constexpr (C::ACC == kAccSmem) {
        if (!ws)   // a split's blocks have no accumulator (nor its memory)
          accs[(i * RN + j) * C::kThreads + tid] = make_float2(0.0f, 0.0f);
      } else if constexpr (C::ACC == kAccRegs)
        hi[i][j] = lo[i][j] = 0.0f;
    }
  }
  auto row = [&](int i) {
    return m0 + i / 4 * (C::BM / (RM / 4)) + ty * 4 + i % 4;
  };
  auto col = [&](int j) {
    return n0 + j / 4 * (C::BN / (RN / 4)) + tx * 4 + j % 4;
  };

  // One K-tile from shared memory, kn of its k (kn < TK only at a
  // K-block's end).
  auto compute_tile = [&](int stage, int kn) {
    const float* const sA = smem + stage * C::kStage + ty * 4;
    const float* const sB = smem + stage * C::kStage + TK * C::PA + tx * 4;
    if (kn >= TK) {
#pragma unroll
      for (int kk = 0; kk < TK; ++kk)
        fma_k<C>(sA + kk * C::PA, sB + kk * C::PB, p);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < kn; ++kk)
        fma_k<C>(sA + kk * C::PA, sB + kk * C::PB, p);
    }
  };

  // The end of K-block kb: its products into the FF accumulator, or out
  // to the workspace; then the next K-block's chains start from +0.
  auto end_block = [&](int kb) {
    if (ws) {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = row(i);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = col(j);
          if (m < M && n < N)
            ws[(static_cast<long long>(kb) * M + m) * N + n] = p[i][j];
        }
      }
    } else if constexpr (C::ACC == kAccOut) {
      // the outputs hold (hi, lo) after the first K-block
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = row(i);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = col(j);
          if (m < M && n < N) {
            const long long o = static_cast<long long>(m) * N + n;
            ff2 h = {0.0f, 0.0f};
            if (kb > kb0) h = {out_hi[o], out_lo[o]};
            const ff2 r = add212(h, p[i][j]);
            out_hi[o] = r.hi;
            out_lo[o] = r.lo;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          if constexpr (C::ACC == kAccSmem) {
            float2& h = accs[(i * RN + j) * C::kThreads + tid];
            const ff2 r = add212({h.x, h.y}, p[i][j]);
            h = make_float2(r.hi, r.lo);
          } else {
            const ff2 r = add212({hi[i][j], lo[i][j]}, p[i][j]);
            hi[i][j] = r.hi;
            lo[i][j] = r.lo;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) p[i][j] = 0.0f;
    }
  };

  Cursor ld(kb0, bk, K), cp(kb0, bk, K);
  if constexpr (S == 1) {                   // synchronous staging
    for (int t = 0; t < ntiles; ++t) {
      load_tile(0, ld);
      ld.advance<TK>(bk, K);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      compute_tile(0, cp.kend - cp.kt);
      __syncthreads();
      if (cp.kt + TK >= cp.kend) end_block(cp.kb);
      cp.advance<TK>(bk, K);
    }
  } else {
#pragma unroll
    for (int t = 0; t < S - 1; ++t) {
      if (t < ntiles) {
        load_tile(t, ld);
        ld.advance<TK>(bk, K);
      }
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      cp_async_wait<S - 2>();               // tile t has landed (this thread)
      __syncthreads();                      // ... for all, and t - 1 is done
      if (t + S - 1 < ntiles) {
        load_tile((t + S - 1) % S, ld);
        ld.advance<TK>(bk, K);
      }
      cp_async_commit();
      compute_tile(t % S, cp.kend - cp.kt);
      if (cp.kt + TK >= cp.kend) end_block(cp.kb);
      cp.advance<TK>(bk, K);
    }
  }
  if (ws) return;
  if constexpr (C::ACC == kAccOut) {
    if (ntiles == 0) {                      // K = 0: (0, 0)
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int m = row(i);
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int n = col(j);
          if (m < M && n < N) {
            out_hi[static_cast<long long>(m) * N + n] = 0.0f;
            out_lo[static_cast<long long>(m) * N + n] = 0.0f;
          }
        }
      }
    }
    return;
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = row(i);
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = col(j);
      if (m < M && n < N) {
        float h, l;
        if constexpr (C::ACC == kAccSmem) {
          const float2 v = accs[(i * RN + j) * C::kThreads + tid];
          h = v.x;
          l = v.y;
        } else {
          h = hi[i][j];
          l = lo[i][j];
        }
        out_hi[static_cast<long long>(m) * N + n] = h;
        out_lo[static_cast<long long>(m) * N + n] = l;
      }
    }
  }
}

// The split's second pass: each output's nkb block products from ws, folded
// from (0, 0) in K-block order.
__global__ void __launch_bounds__(256)
fold_kernel(const float* __restrict__ ws, float* __restrict__ out_hi,
            float* __restrict__ out_lo, long long mn, int nkb) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    ffk::ff2 r = {0.0f, 0.0f};
    for (int kb = 0; kb < nkb; ++kb) r = ffk::add212(r, ws[kb * mn + i]);
    out_hi[i] = r.hi;
    out_lo[i] = r.lo;
  }
}

template <typename C, bool VA, bool VB>
int launch_copies(Operand a, Operand b, float* hi, float* lo, float* ws,
                  int M, int N, int K, int bk, int kbs, int splits,
                  bool a_kfast, bool b_kfast, cudaStream_t stream) {
  auto kernel = hybrid_kernel<C, VA, VB>;
  // above 48 KB only by this attribute (per device: set at every launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long gy = (static_cast<long long>(M) + C::BM - 1) / C::BM;
  if (gy > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + C::BN - 1) / C::BN, static_cast<unsigned>(gy), splits);
  // a split's blocks fold nothing: the ring alone, more blocks an SM
  kernel<<<grid, C::kThreads, ws ? C::kRing : C::kSmem, stream>>>(
      a, b, hi, lo, ws, M, N, K, bk, kbs, a_kfast, b_kfast);
  return static_cast<int>(cudaGetLastError());
}

template <typename C>
int launch_layout(Operand a, Operand b, float* hi, float* lo, float* ws,
                  int M, int N, int K, int bk, int kbs, int splits,
                  cudaStream_t stream) {
  // 16-byte copies: contiguous along the tile's fast axis (M for A, N for
  // B), every row 16-byte aligned
  const bool va = a.s0 == 1 && a.s1 % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(a.p) % 16 == 0;
  const bool vb = b.s1 == 1 && b.s0 % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(b.p) % 16 == 0;
  // 4-byte copies: consecutive threads along the operand's contiguous axis
  const bool a_kfast = a.s1 == 1 || a.s0 != 1;
  const bool b_kfast = !(b.s1 == 1 || b.s0 != 1);
  if (va && vb)
    return launch_copies<C, true, true>(a, b, hi, lo, ws, M, N, K, bk, kbs,
                                      splits, a_kfast, b_kfast, stream);
  if (va)
    return launch_copies<C, true, false>(a, b, hi, lo, ws, M, N, K, bk, kbs,
                                       splits, a_kfast, b_kfast, stream);
  if (vb)
    return launch_copies<C, false, true>(a, b, hi, lo, ws, M, N, K, bk, kbs,
                                       splits, a_kfast, b_kfast, stream);
  return launch_copies<C, false, false>(a, b, hi, lo, ws, M, N, K, bk, kbs,
                                      splits, a_kfast, b_kfast, stream);
}

}  // namespace

// a (M, K) and b (K, N) f32 with element strides (sa0, sa1), (sb0, sb1);
// out_hi, out_lo (M, N) contiguous.  bk: the K-block of the fold.  splits:
// blocks over the K-blocks of each output tile (1: none), with ws a
// workspace of ceil(K / bk) M N floats where splits > 1.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int ff_matmul_f32(const float* a, long long sa0, long long sa1,
                             const float* b, long long sb0, long long sb1,
                             float* out_hi, float* out_lo, int M, int N,
                             int K, int bk, int splits, float* ws,
                             cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (bk < 1 || splits < 1 || (splits > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nkb = (K + bk - 1) / bk;
  const int kbs = splits > 1 ? (nkb + splits - 1) / splits : max(nkb, 1);
  const int nsplit = splits > 1 ? (nkb + kbs - 1) / kbs : 1;
  float* const w = nsplit > 1 ? ws : nullptr;
  const int err = launch_layout<Shipped>({a, sa0, sa1}, {b, sb0, sb1}, out_hi,
                                         out_lo, w, M, N, K, bk, kbs, nsplit,
                                         stream);
  if (err || !w) return err;
  const long long mn = static_cast<long long>(M) * N;
  int grid = 0;
  if (int e = ffk::elementwise_grid(mn, 256, 8, &grid)) return e;
  fold_kernel<<<grid, 256, 0, stream>>>(w, out_hi, out_lo, mn, nkb);
  return static_cast<int>(cudaGetLastError());
}
