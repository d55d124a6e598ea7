// FF flash attention: softmax(q k^T * scale) v with float-float scores,
// weights, numerator and denominator (the compensated online softmax).
//
// Replaces the TPU kernel src/repro/kernels/ff_attention.py::
// flash_attention_pallas (_attn_kernel, :312-494).
//
// What bounds it on this card: operations.  Every (q, k) pair costs a
// TwoProd-exact Neumaier cascade over the head dim (31 f32 instructions per
// element, no FMA allowed), an exp22 (~330) and a TwoProd p*v cascade over
// the head dim (33 per element): about 4,500 instructions per pair at
// hd = 64, against 3 to 6 bytes of input per pair.  (bf16 operands need
// only ~2,600: their products are exact and v splits into (v, 0); this
// kernel runs the general f32 sequence on both types.)  The tensor cores
// cannot carry the EFTs, so the bound is the f32 lanes (132 SMs x 128).
//
// Design: one block of 256 threads per (batch*head, 16-row q tile).  The
// TPU's sequential kv grid axis becomes a loop inside the block over 64-row
// K/V tiles staged in shared memory as f32 (K padded by one word per row:
// no bank conflicts when 32 threads read 32 keys).  Per tile:
//   1. one thread per (q, k) pair: TwoProd-exact products summed through a
//      Neumaier cascade over the head dim, folded and scaled by Mul212;
//      the causal and Skv-edge masks set masked scores to -1e30;
//   2. one thread per row: the new running max and the FF rescale factor
//      alpha = exp22(TwoSum(m_old, -m_new));
//   3. one thread per pair: the Add212 shift by the new max and exp22;
//   4. one thread per row: the tile's weight sum as a per-lane Neumaier
//      cascade over both limb planes folded in lane order (the reference's
//      _lane_cascade/_fold_lanes with 64 lanes), then den = Add22(Mul22(
//      den, alpha), sum); in the same phase one thread per (row, d) runs
//      the TwoProd p*v cascade and num = Add22(Mul22(num, alpha), pv), the
//      FF numerator living in registers across tiles.
// The finish applies the reference's 1e-30 safe denominator and Div22.
// GQA maps head h to KV head h / (H / KV), as kv_row does.  Simple first:
// no tensor cores, no TMA, every tile computed in full (masked pairs too).

#include <cuda_bf16.h>

#include "ff_eft.cuh"

namespace {

constexpr int kBQ = 16;        // q rows per block
constexpr int kBKV = 64;       // keys per shared-memory tile
constexpr int kHDMax = 64;     // largest head dim the kernel takes
constexpr int kThreads = 256;
constexpr int kSlots = kBQ * kHDMax / kThreads;   // numerator cells/thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Neumaier step of the lane cascade: (s, c, cc) += x.
__device__ __forceinline__ void cascade(float& s, float& c, float& cc,
                                        float x) {
  ffk::ff2 t = ffk::two_sum(s, x);
  ffk::ff2 u = ffk::two_sum(c, t.lo);
  s = t.hi;
  c = u.hi;
  cc = ffk::add(cc, u.lo);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ff_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ out_hi,
                    float* __restrict__ out_lo, int Sq, int Skv, int H,
                    int KV, int hd, int causal, int q_offset, float scale) {
  using namespace ffk;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;

  __shared__ float qs[kBQ][kHDMax];
  __shared__ float ks[kBKV][kHDMax + 1];
  __shared__ float vs[kBKV][kHDMax];
  __shared__ float ph[kBQ][kBKV + 1];    // scores, then weights (hi limb)
  __shared__ float pl[kBQ][kBKV + 1];    // ... (lo limb)
  __shared__ float m_row[kBQ], dh_row[kBQ], dl_row[kBQ];
  __shared__ float ah_row[kBQ], al_row[kBQ];

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    qs[r][d] = qi < Sq
        ? load_f32(q + ((static_cast<size_t>(b) * Sq + qi) * H + h) * hd + d)
        : 0.0f;
  }
  if (tid < kBQ) {
    m_row[tid] = kNegInf;
    dh_row[tid] = 0.0f;
    dl_row[tid] = 0.0f;
  }
  float nh[kSlots], nl[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) nh[i] = nl[i] = 0.0f;

  const int n_tiles = (Skv + kBKV - 1) / kBKV;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBKV * hd; i += kThreads) {
      const int c = i / hd, d = i % hd, kj = k0 + c;
      const size_t off =
          ((static_cast<size_t>(b) * Skv + kj) * KV + kvh) * hd + d;
      ks[c][d] = kj < Skv ? load_f32(k + off) : 0.0f;
      vs[c][d] = kj < Skv ? load_f32(v + off) : 0.0f;
    }
    __syncthreads();

    // 1. FF scores
    for (int i = tid; i < kBQ * kBKV; i += kThreads) {
      const int r = i / kBKV, c = i % kBKV;
      float s = 0.0f, cs = 0.0f, cc = 0.0f;
      for (int d = 0; d < hd; ++d) {
        ff2 p = two_prod(qs[r][d], ks[c][d]);
        ff2 t = two_sum(s, p.hi);
        ff2 u = two_sum(cs, t.lo);
        s = t.hi;
        cs = u.hi;
        cc = add(add(cc, u.lo), p.lo);
      }
      ff2 s0 = two_sum(s, cs);
      ff2 sc = mul212(fast_two_sum(s0.hi, add(s0.lo, cc)), scale);
      const int col = k0 + c, row = q_offset + q0 + r;
      const bool ok = col < Skv && (!causal || col <= row);
      ph[r][c] = ok ? sc.hi : kNegInf;
      pl[r][c] = ok ? sc.lo : 0.0f;
    }
    __syncthreads();

    // 2. running max and FF rescale factor
    if (tid < kBQ) {
      const int r = tid;
      float mx = ph[r][0];
      for (int c = 1; c < kBKV; ++c) mx = fmaxf(mx, ph[r][c]);
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, mx);
      ff2 a = two_sum(m_old, -m_new);
      ff2 alpha = exp22(a.hi, a.lo);
      ah_row[r] = alpha.hi;
      al_row[r] = alpha.lo;
      m_row[r] = m_new;
    }
    __syncthreads();

    // 3. FF weights exp22(s - m_new)
    for (int i = tid; i < kBQ * kBKV; i += kThreads) {
      const int r = i / kBKV, c = i % kBKV;
      const int col = k0 + c, row = q_offset + q0 + r;
      const bool ok = col < Skv && (!causal || col <= row);
      ff2 d = add212({ph[r][c], pl[r][c]}, -m_row[r]);
      ff2 e = exp22(d.hi, d.lo);
      ph[r][c] = ok ? e.hi : 0.0f;
      pl[r][c] = ok ? e.lo : 0.0f;
    }
    __syncthreads();

    // 4a. denominator: per-lane cascade over both limb planes, lane fold
    if (tid < kBQ) {
      const int r = tid;
      float fh = 0.0f, fl = 0.0f;
      for (int l = 0; l < kBKV; ++l) {
        float s = 0.0f, c = 0.0f, cc = 0.0f;
        cascade(s, c, cc, ph[r][l]);
        cascade(s, c, cc, pl[r][l]);
        ff2 t = two_sum(fh, s);
        ff2 f = fast_two_sum(t.hi, add(t.lo, add(add(fl, c), cc)));
        fh = f.hi;
        fl = f.lo;
      }
      ff2 d0 = mul22({dh_row[r], dl_row[r]}, {ah_row[r], al_row[r]});
      ff2 d1 = add22(d0, {fh, fl});
      dh_row[r] = d1.hi;
      dl_row[r] = d1.lo;
    }

    // 4b. numerator: TwoProd p*v cascade over the tile's keys
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kBQ * hd) {
        const int r = idx / hd, d = idx % hd;
        float s = 0.0f, c = 0.0f, cc = 0.0f;
        for (int j = 0; j < kBKV; ++j) {
          const float vt = vs[j][d];
          ff2 p = two_prod(ph[r][j], vt);
          const float tl = add(p.lo, mul(pl[r][j], vt));
          ff2 t = two_sum(s, p.hi);
          ff2 u = two_sum(c, t.lo);
          s = t.hi;
          c = u.hi;
          cc = add(add(cc, u.lo), tl);
        }
        ff2 pv = two_sum(s, c);
        pv = fast_two_sum(pv.hi, add(pv.lo, cc));
        ff2 n0 = mul22({nh[i], nl[i]}, {ah_row[r], al_row[r]});
        ff2 n1 = add22(n0, pv);
        nh[i] = n1.hi;
        nl[i] = n1.lo;
      }
    }
  }
  __syncthreads();   // the last denominator update is visible

#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < kBQ * hd) {
      const int r = idx / hd, d = idx % hd, qi = q0 + r;
      if (qi < Sq) {
        const bool ok = dh_row[r] > 1e-30f;
        ff2 den = {ok ? dh_row[r] : 1e-30f, ok ? dl_row[r] : 0.0f};
        ff2 o = div22({nh[i], nl[i]}, den);
        const size_t off = ((static_cast<size_t>(b) * Sq + qi) * H + h) * hd + d;
        out_hi[off] = o.hi;
        out_lo[off] = o.lo;
      }
    }
  }
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), contiguous, f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1); out_hi, out_lo: (B, Sq, H, hd) f32.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int ff_attention_fwd(const void* q, const void* k, const void* v,
                                float* out_hi, float* out_lo, int is_bf16,
                                int B, int Sq, int Skv, int H, int KV, int hd,
                                int causal, int q_offset, float scale,
                                cudaStream_t stream) {
  if (hd < 1 || hd > kHDMax || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  if (grid.x == 0 || grid.y == 0) return static_cast<int>(cudaGetLastError());
  if (is_bf16) {
    ff_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), out_hi, out_lo, Sq, Skv, H, KV,
        hd, causal, q_offset, scale);
  } else {
    ff_attention_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), out_hi, out_lo, Sq, Skv, H, KV, hd,
        causal, q_offset, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
