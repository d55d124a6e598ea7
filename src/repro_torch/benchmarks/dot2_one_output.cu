// The Dot2 FF matmul kernel's earlier design, kept as the baseline of
// repro_torch.benchmarks.dot2_variants (which builds it in place of
// csrc/ff_matmul_dot2.cu): one output a thread, 16 x 16 outputs a block,
// each product's operands read from shared memory (no register tile), A
// and B tiles of 4 slabs staged synchronously (two barriers a tile, no
// load in flight during compute).  The same op sequence per output as
// csrc/ff_matmul_dot2.cu, so the same bits; the C entry is the same.

#include "ff_eft.cuh"

namespace {

constexpr int kSide = 16;       // outputs per block side, one per thread

// One level of the pairwise tree over p[0..W), then the next level.
template <int W, int VEC>
struct Tree {
  static __device__ __forceinline__ void run(float (&p)[VEC], float& err) {
    using namespace ffk;
    constexpr int H = W / 2;
    float esum = 0.0f;
#pragma unroll
    for (int t = 0; t < H; ++t) {
      ff2 r = two_sum(p[t], p[t + H]);
      p[t] = r.hi;
      esum = add(esum, r.lo);
    }
    err = add(err, esum);
    if (W & 1) p[H] = p[W - 1];
    Tree<H + (W & 1), VEC>::run(p, err);
  }
};

template <int VEC>
struct Tree<1, VEC> {
  static __device__ __forceinline__ void run(float (&)[VEC], float&) {}
};

template <int VEC>
__global__ void __launch_bounds__(kSide * kSide)
dot2_kernel(const float* __restrict__ a, long long sa0, long long sa1,
            const float* __restrict__ b, long long sb0, long long sb1,
            float* __restrict__ out_hi, float* __restrict__ out_lo, int M,
            int N, int K) {
  using namespace ffk;
  constexpr int kSlabs = 4;                 // slabs per shared tile
  constexpr int kTk = kSlabs * VEC;
  __shared__ float As[kSide][kTk + 1];
  __shared__ float Bs[kTk][kSide];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int m0 = blockIdx.y * kSide, n0 = blockIdx.x * kSide;
  const int kpad = (K + VEC - 1) / VEC * VEC;   // whole slabs
  float s = 0.0f, c = 0.0f, cc = 0.0f;

  for (int kt = 0; kt < kpad; kt += kTk) {
    for (int l = tid; l < kSide * kTk; l += kSide * kSide) {
      const int mm = l / kTk, kk = l % kTk;
      const int gm = m0 + mm, gk = kt + kk;
      As[mm][kk] = (gm < M && gk < K) ? a[gm * sa0 + gk * sa1] : 0.0f;
      const int kb = l / kSide, nn = l % kSide;
      const int gn = n0 + nn, gkb = kt + kb;
      Bs[kb][nn] = (gn < N && gkb < K) ? b[gkb * sb0 + gn * sb1] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      if (kt + sl * VEC >= kpad) break;     // past the last slab
      float p[VEC];
      float err = 0.0f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        ff2 t = two_prod_fma(As[ty][sl * VEC + v], Bs[sl * VEC + v][tx]);
        p[v] = t.hi;
        err = add(err, t.lo);
      }
      Tree<VEC, VEC>::run(p, err);
      ff2 u = two_sum(s, p[0]);
      ff2 w = two_sum(c, add(u.lo, err));
      s = u.hi;
      c = w.hi;
      cc = add(cc, w.lo);
    }
    __syncthreads();
  }

  const int m = m0 + ty, n = n0 + tx;
  if (m < M && n < N) {
    ff2 r = fast_two_sum(s, add(c, cc));
    out_hi[static_cast<long long>(m) * N + n] = r.hi;
    out_lo[static_cast<long long>(m) * N + n] = r.lo;
  }
}

template <int VEC>
void launch(const float* a, long long sa0, long long sa1, const float* b,
            long long sb0, long long sb1, float* hi, float* lo, int M, int N,
            int K, cudaStream_t stream) {
  dim3 grid((N + kSide - 1) / kSide, (M + kSide - 1) / kSide);
  dot2_kernel<VEC><<<grid, dim3(kSide, kSide), 0, stream>>>(
      a, sa0, sa1, b, sb0, sb1, hi, lo, M, N, K);
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
  if (M > 0 && N > 0) {
    switch (vec) {
      case 1: launch<1>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 2: launch<2>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 3: launch<3>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 4: launch<4>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 5: launch<5>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 6: launch<6>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 7: launch<7>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      case 8: launch<8>(a, sa0, sa1, b, sb0, sb1, out_hi, out_lo, M, N, K, stream); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
