// A check kernel, not on any model path: the earlier design of the hybrid
// FF matrix product (csrc/ff_matmul.cu), kept as it was.  chip_smoke.py
// holds the shipped kernel to it bit for bit: both run each output's
// K-block product as one __fmaf_rn chain from +0 over k in order and fold
// the block products into (hi, lo) with add212 in K-block order, so any
// tiling gives its bits.  It has no launch count and is not in the kernels
// line; repro_torch.benchmarks.hybrid_variants times it as a row.
//
// Its design: a shared-memory tiled SIMT GEMM, 64 x 64 output tile per
// block of 256 threads, each thread 4 x 4 outputs (rows ty + 16 i,
// columns tx + 16 j, so the shared-memory reads are broadcasts or
// consecutive), a K depth of 16 per shared tile staged synchronously, the
// block product and the FF accumulator in registers.  The operands are
// read through their strides.

#include "ff_eft.cuh"

namespace {

constexpr int kTile = 64;       // output rows and columns per block
constexpr int kTk = 16;         // K depth of one shared-memory tile
constexpr int kSide = 16;       // threads per side; each 4 x 4 outputs
constexpr int kThreads = kSide * kSide;

struct Operand {
  const float* p;
  long long s0, s1;             // element (r, c) at p[r * s0 + c * s1]
};

// acc[i][j] += A[m0 + ty + 16 i, k] * B[k, n0 + tx + 16 j] for k in [k0, k1),
// in k order.  Out-of-range rows and columns read as 0 (their outputs are
// not written).
__device__ __forceinline__ void block_product(
    Operand a, Operand b, int M, int N, int m0, int n0, int k0, int k1,
    float (*As)[kTile + 1], float (*Bs)[kTile + 1], float acc[4][4]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const bool a_kfast = a.s1 == 1 || a.s0 != 1;  // consecutive threads on k
  const bool b_nfast = b.s1 == 1 || b.s0 != 1;  // consecutive threads on n
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int kt = k0; kt < k1; kt += kTk) {
#pragma unroll
    for (int r = 0; r < kTile * kTk / kThreads; ++r) {
      const int l = tid + r * kThreads;
      const int kk = a_kfast ? l % kTk : l / kTile;
      const int mm = a_kfast ? l / kTk : l % kTile;
      const int gm = m0 + mm, gk = kt + kk;
      As[kk][mm] = (gm < M && gk < k1) ? a.p[gm * a.s0 + gk * a.s1] : 0.0f;
      const int nn = b_nfast ? l % kTile : l / kTk;
      const int kb = b_nfast ? l / kTile : l % kTk;
      const int gn = n0 + nn, gkb = kt + kb;
      Bs[kb][nn] = (gn < N && gkb < k1) ? b.p[gkb * b.s0 + gn * b.s1] : 0.0f;
    }
    __syncthreads();
    const int kn = min(kTk, k1 - kt);
    for (int kk = 0; kk < kn; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// The hybrid kernel: per K-block, the f32 block product folded into the
// FF accumulator.  Two blocks an SM (<= 128 registers a thread): left to
// itself the compiler takes 164 and one block an SM, 15% slower.
__global__ void __launch_bounds__(kThreads, 2)
fold_gemm_kernel(Operand a, Operand b, float* __restrict__ out_hi,
                 float* __restrict__ out_lo, int M, int N, int K, int bk) {
  __shared__ float As[kTk][kTile + 1];
  __shared__ float Bs[kTk][kTile + 1];
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float hi[4][4], lo[4][4], p[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) hi[i][j] = lo[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += bk) {
    const int k1 = min(K, k0 + bk);
    block_product(a, b, M, N, m0, n0, k0, k1, As, Bs, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ffk::ff2 r = ffk::add212({hi[i][j], lo[i][j]}, p[i][j]);
        hi[i][j] = r.hi;
        lo[i][j] = r.lo;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + threadIdx.y + kSide * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + threadIdx.x + kSide * j;
      if (m < M && n < N) {
        out_hi[static_cast<long long>(m) * N + n] = hi[i][j];
        out_lo[static_cast<long long>(m) * N + n] = lo[i][j];
      }
    }
  }
}

dim3 grid_for(int M, int N) {
  return dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
}

}  // namespace

// a (M, K) and b (K, N) f32 with element strides (sa0, sa1), (sb0, sb1);
// out_hi, out_lo (M, N) contiguous.  bk: the K-block of the fold.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int ff_matmul_hybrid_check_f32(const float* a, long long sa0,
                                         long long sa1,
                                         const float* b, long long sb0,
                                         long long sb1, float* out_hi,
                                         float* out_lo, int M, int N, int K,
                                         int bk, cudaStream_t stream) {
  if (M > 0 && N > 0) {
    fold_gemm_kernel<<<grid_for(M, N), dim3(kSide, kSide), 0, stream>>>(
        {a, sa0, sa1}, {b, sb0, sb1}, out_hi, out_lo, M, N, K, bk);
  }
  return static_cast<int>(cudaGetLastError());
}
