// FF flash attention: softmax(q k^T * scale) v with float-float scores,
// weights, numerator and denominator (the compensated online softmax).
//
// Replaces the TPU kernel src/repro/kernels/ff_attention.py::
// flash_attention_pallas (_attn_kernel, :312-420).
//
// What bounds it on this card: operations.  Every (q, k) pair that can
// count costs a Neumaier cascade over the head dim for its score (14 f32
// instructions an element for bf16 operands, whose products are exact in
// f32; 16 with an FMA TwoProd for f32 ones), an exp22 (~210 on the FMA
// path) and a TwoProd p*v cascade over the head dim (18 an element): about
// 2,300 instructions a pair at hd = 64 against 3 to 6 bytes of input.  The
// tensor cores cannot carry the EFTs (they need IEEE f32 products), so the
// bound is the f32 lanes (132 SMs x 128).
//
// Design: one block per (batch, HB query heads of one KV head, q tile), its
// R = HB x PB rows (PB q positions of HB heads sharing one staged K/V tile:
// GQA sharing).  The TPU's sequential kv grid axis becomes a loop inside
// the block over 64-key K/V tiles staged in shared memory as f32.  Thread
// (ty, tx) owns TR rows x TK keys in the score phase and the same TR rows x
// TK head-dim cells in the p*v phase, so a q or k value in a register feeds
// TK or TR score steps and a p or v value TK or TR p*v steps.  Per tile:
//   1. FF scores: exact products (one multiply for bf16 operands: a bf16
//      product has at most 16 significant bits, so Dekker's low part is 0
//      and his high part the product; two_prod_fma for f32 ones) summed
//      through a Neumaier cascade over the head dim, folded, scaled by
//      Mul212; the causal and Skv-edge masks set masked scores to -1e30;
//   2. the running max by warp shuffles over the TK-key groups of a row
//      (the row's threads lie in one warp), and alpha = exp22(TwoSum(
//      m_old, -m_new)) evaluated once per row by one lane, shuffled to the
//      row's other lanes;
//   3. the FF weights exp22(Add212(s, -m_new)) (exp22's bits: exp22_fma
//      where its test passes, exp22 elsewhere), each lane on its own pairs,
//      into shared memory;
//      each lane cascades its pairs' two limbs into a Neumaier triple per
//      row (both planes, as the reference's lanes do), folds it, and a
//      shuffle tree of Add22s (lower lane first, so that every lane gets
//      the same bits) sums the row's lanes: den = Add22(Mul22(den, alpha),
//      sum).  This order differs from the reference's 128-lane fold; both
//      are within the 2^-40 contract, and the tree runs on every lane where
//      the lane fold ran on one thread a row;
//   4. the p*v cascade over the tile's keys (two_prod_fma(p.hi, v), the
//      lo-plane product in the residual), num = Add22(Mul22(num, alpha),
//      pv), the FF numerator in registers across tiles.  A warp reads only
//      its own rows' weights, so the phases meet at __syncwarp.
// The finish applies the reference's 1e-30 safe denominator and Div22.
//
// Causal tiles and sub-tiles are skipped.  A q tile loops only over the K/V
// tiles that hold a key <= its last position; inside a tile a warp computes
// only the KX-key sub-tiles that hold a key <= its rows' last position (and
// < Skv), and its p*v loop stops at that key.  A skipped part is one whose
// scores are all -1e30 for the warp's rows, and skipping it is neutral in
// this recurrence: m_new = max(m_old, -1e30) = m_old (m starts at -1e30),
// TwoSum(m_old, -m_old) = (+0, +0), exp22(+0, +0) = (1, 0), its weights are
// 0, so its sum is (+0, +0) and its p*v cascade (+0, +0); Mul22 by (1, 0)
// and Add22 of (+0, +0) return a normalised FF value bit for bit where no
// limb is -0 (a -0 limb may come back +0: the same value), so the state
// after it is the state before.  The first tile (k0 = 0) always holds key 0, which every row
// sees, so only trailing parts are ever skipped.
// tests/test_torch_attention_plan.py checks these identities on the port's
// plain EFTs.  Blocks launch longest q tile first (the last q tiles have
// the most keys under a causal mask).
//
// TwoProd.  two_prod_fma gives Dekker's bits wherever Dekker's is exact;
// where it is not (partial products below ~2^-100: weights far below the
// row's max), the FMA form is the exact one, so the kernel can only move
// closer to the float64 oracle.  The plain version keeps the reference's
// Dekker sequence; the two may differ there, far below 2^-40.
//
// The tiles: Config<R, TR, TK, MINB> below; the wrapper picks one per shape
// (kernels/ff_attention.py attention_plan: the largest whose blocks occupy
// every SM) and HB (4, 2 or 1: the largest that divides H / KV).  A 4 x 4
// thread tile takes ~233 registers (the cascades' triples, the FF
// numerator, four exp22 in flight), so Big runs one block an SM: capped at
// 128 registers for two it spills and runs 1.08-1.35x slower; a 2 x 2 tile
// takes ~94.  No library kernel, no tensor cores.
//
// Head dims.  The instance's head dim HD (64, 128, 192: the dense and MoE
// configs' 64 and 128, MLA's prefill 128 + 64) sizes the shared-memory
// tiles; hd <= HD at run time (hd <= 64 runs the HD = 64 instance, the
// head dim beyond hd zero).  The score cascade walks hd.  The p*v phase
// walks the head dim in HD / 64 chunks of 64 cells, the thread's TK cells
// of each (one Neumaier triple live at a time), so a thread holds
// TR x TK x HD / 64 FF numerator cells across tiles.  The arithmetic is
// the same at every HD.  At HD = 192 a Big block takes 184 KB of shared
// memory and a Small one 121.5 KB: one block an SM for either.

#include <cuda_bf16.h>

#include "ff_eft.cuh"

namespace {

constexpr int kBKV = 64;       // keys per shared-memory tile
constexpr float kNegInf = -1e30f;

// Design switches (benchmarks/attention_variants.py edits them).
constexpr bool kSkipTiles = true;     // skip causal / Skv-edge (sub-)tiles
constexpr bool kExactBf16 = true;     // a bf16 score product: one multiply
constexpr bool kFmaTwoProd = true;    // TwoProd as a multiply and an FMA
constexpr bool kLongestFirst = true;  // the q tiles of most keys first
constexpr bool kExpInline = true;     // exp22's own body inline

// R rows a block, TR x TK pairs (and cells) a thread, MINB blocks an SM.
template <int R, int TR, int TK, int MINB>
struct Config {
  static constexpr int kRows = R, kTR = TR, kTK = TK, kMinBlocks = MINB;
  static constexpr int kKX = kBKV / TK;           // threads along keys / d
  static constexpr int kThreads = R / TR * kKX;
  static constexpr int kQS = R + TR;              // qT, ph, pl row stride
  static constexpr int kKS = kBKV + 4;            // kT row stride
  static_assert(kKX <= 32 && 32 % kKX == 0, "a row's lanes in one warp");
  static_assert(TR <= kKX && R % TR == 0, "tile shape");
};

using Big = Config<64, 4, 4, 1>;     // plan 0: 256 threads, 4 x 4 a thread
using Small = Config<16, 2, 2, 2>;   // plan 1: 256 threads, 2 x 2 a thread

// the shared memory of a block of C at head dim HD: qT, kT, vs, ph and pl
template <class C, int HD>
constexpr int smem_floats() {
  return HD * C::kQS + HD * C::kKS + kBKV * HD + 2 * kBKV * C::kQS;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ ffk::ff2 tp(float a, float b) {
  if constexpr (kFmaTwoProd) return ffk::two_prod_fma(a, b);
  else return ffk::two_prod(a, b);
}

// Mul212 on tp.
__device__ __forceinline__ ffk::ff2 mul212_tp(ffk::ff2 a, float b) {
  ffk::ff2 t = tp(a.hi, b);
  return ffk::fast_two_sum(t.hi, ffk::add(t.lo, ffk::mul(a.lo, b)));
}

// exp22(xh, xl) bit for bit: exp22_fma where its test on the reduced
// argument passes, exp22 itself elsewhere (inline, or out of line as
// exp22_fmapath runs it).
__device__ __forceinline__ ffk::ff2 exp22_w(float xh, float xl) {
  if constexpr (kExpInline) {
    bool ok;
    ffk::ff2 r = ffk::exp22_fma(xh, xl, &ok);
    if (!ok) r = ffk::exp22(xh, xl);
    return r;
  } else {
    return ffk::exp22_fmapath(xh, xl);
  }
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

template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// The score cascades of the thread's TR rows x its keys in the first NS
// sub-tiles (key tx + KX j, j < NS), over the head dim.
template <class C, int NS, bool kBf16>
__device__ __forceinline__ void score_tile(
    const float* qT, const float* kT, int hd, int ty, int tx,
    float (&s)[C::kTR][C::kTK], float (&c)[C::kTR][C::kTK],
    float (&cc)[C::kTR][C::kTK]) {
  using namespace ffk;
  constexpr int TR = C::kTR, TK = C::kTK;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[i][j] = c[i][j] = cc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < hd; ++d) {
    float qv[TR], kv[TK];
    lds<TR>(qT + d * C::kQS + TR * ty, qv);
    lds<TK>(kT + d * C::kKS + TK * tx, kv);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if constexpr (kBf16 && kExactBf16) {
          // exact: TwoProd's low part would be 0, and cc + u.lo + 0 is
          // cc + u.lo (cc starts at +0 and is never -0)
          const float p = mul(qv[i], kv[j]);
          ff2 t = two_sum(s[i][j], p);
          ff2 u = two_sum(c[i][j], t.lo);
          s[i][j] = t.hi;
          c[i][j] = u.hi;
          cc[i][j] = add(cc[i][j], u.lo);
        } else {
          ff2 p = tp(qv[i], kv[j]);
          ff2 t = two_sum(s[i][j], p.hi);
          ff2 u = two_sum(c[i][j], t.lo);
          s[i][j] = t.hi;
          c[i][j] = u.hi;
          cc[i][j] = add(add(cc[i][j], u.lo), p.lo);
        }
      }
  }
}

// score_tile for a runtime ns in [1, TK].
template <class C, bool kBf16, int NS = 1>
__device__ __forceinline__ void scores(
    int ns, const float* qT, const float* kT, int hd, int ty, int tx,
    float (&s)[C::kTR][C::kTK], float (&c)[C::kTR][C::kTK],
    float (&cc)[C::kTR][C::kTK]) {
  if constexpr (NS < C::kTK) {
    if (ns == NS) score_tile<C, NS, kBf16>(qT, kT, hd, ty, tx, s, c, cc);
    else scores<C, kBf16, NS + 1>(ns, qT, kT, hd, ty, tx, s, c, cc);
  } else {
    score_tile<C, NS, kBf16>(qT, kT, hd, ty, tx, s, c, cc);
  }
}

template <class C, int HD, typename T>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
ff_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ out_hi,
                    float* __restrict__ out_lo, int Sq, int Skv, int H,
                    int KV, int hd, int causal, int q_offset, float scale,
                    int hb_shift, int n_qt) {
  using namespace ffk;
  constexpr int R = C::kRows, TR = C::kTR, TK = C::kTK, KX = C::kKX;
  constexpr int NT = C::kThreads;
  constexpr int NC = HD / kBKV;                  // head-dim chunks of 64
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [d][R + TR]
  float* kT = qT + HD * C::kQS;                  // [d][key slot]
  float* vs = kT + HD * C::kKS;                  // [key][d]
  float* ph = vs + kBKV * HD;                    // [key][R + TR]
  float* pl = ph + kBKV * C::kQS;

  const int HB = 1 << hb_shift;
  const int groups = H >> hb_shift;              // head groups a batch row
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) << hb_shift;
  const int kvh = h0 / (H / KV);
  const int qt = kLongestFirst ? n_qt - 1 - static_cast<int>(blockIdx.y)
                               : static_cast<int>(blockIdx.y);
  const int q0 = qt * (R >> hb_shift);
  const int tid = threadIdx.x, tx = tid % KX, ty = tid / KX;
  const int lane = tid & 31;
  const int row_lane0 = lane & ~(KX - 1);        // the row group's lane 0
  // the last q position of the warp's rows and of the block's
  const int wpos = q_offset + q0 +
                   ((TR * (((tid & ~31) + 31) / KX) + TR - 1) >> hb_shift);
  const int bpos = q_offset + q0 + (R >> hb_shift) - 1;

  for (int i = tid; i < R * hd; i += NT) {
    const int r = i / hd, d = i - r * hd, qi = q0 + (r >> hb_shift);
    const int h = h0 + (r & (HB - 1));
    qT[d * C::kQS + r] =
        qi < Sq ? load_f32(q + ((static_cast<size_t>(b) * Sq + qi) * H + h)
                                       * hd + d)
                : 0.0f;
  }

  float m[TR], dh[TR], dl[TR], nh[TR][NC * TK], nl[TR][NC * TK];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    dh[i] = dl[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC * TK; ++j) nh[i][j] = nl[i][j] = 0.0f;
  }

  // the tiles that hold a key some row of the block can see
  int last = Skv - 1;
  if (kSkipTiles && causal) last = min(last, bpos);
  const int n_tiles = last < 0 ? 0 : last / kBKV + 1;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBKV;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBKV * HD; i += NT) {
      const int cidx = i / HD, d = i % HD, kj = k0 + cidx;
      const bool ok = kj < Skv && d < hd;
      const size_t off =
          ((static_cast<size_t>(b) * Skv + kj) * KV + kvh) * hd + d;
      kT[d * C::kKS + (cidx % KX) * TK + cidx / KX] =
          ok ? load_f32(k + off) : 0.0f;
      vs[cidx * HD + d] = ok ? load_f32(v + off) : 0.0f;
    }
    __syncthreads();

    // the keys [0, jn) of this tile that the warp's rows can see
    int jn = kBKV;
    if (kSkipTiles) {
      jn = min(jn, Skv - k0);
      if (causal) jn = min(jn, wpos - k0 + 1);
    }
    if (jn <= 0) continue;   // warp-uniform; neutral (see the top)
    const int ns = (jn + KX - 1) / KX;

    // 1. FF scores into ph / pl, and the row maxima
    float s[TR][TK], c[TR][TK], cc[TR][TK];
    scores<C, kBf16>(ns, qT, kT, hd, ty, tx, s, c, cc);
    float mx[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) mx[i] = kNegInf;
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      if (j < ns) {
        const int col = k0 + tx + KX * j;
        float sh[TR], sl[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int pos = q_offset + q0 + ((TR * ty + i) >> hb_shift);
          const bool ok = col < Skv && (!causal || col <= pos);
          ff2 s0 = two_sum(s[i][j], c[i][j]);
          ff2 sc = mul212_tp(fast_two_sum(s0.hi, add(s0.lo, cc[i][j])),
                             scale);
          sh[i] = ok ? sc.hi : kNegInf;
          sl[i] = ok ? sc.lo : 0.0f;
          mx[i] = fmaxf(mx[i], sh[i]);
        }
        sts<TR>(ph + (tx + KX * j) * C::kQS + TR * ty, sh);
        sts<TR>(pl + (tx + KX * j) * C::kQS + TR * ty, sl);
      }
    }

    // 2. running max over the row's lanes; alpha once a row
    float mn[TR], ah[TR], al[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int off = KX / 2; off >= 1; off >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], off));
      mn[i] = fmaxf(m[i], mx[i]);
    }
    {
      const int il = tx % TR;
      float mo = m[0], mw = mn[0];
#pragma unroll
      for (int i = 1; i < TR; ++i) {
        mo = il == i ? m[i] : mo;
        mw = il == i ? mn[i] : mw;
      }
      ff2 a = two_sum(mo, -mw);
      ff2 e = exp22_w(a.hi, a.lo);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        ah[i] = __shfl_sync(kAll, e.hi, row_lane0 + i);
        al[i] = __shfl_sync(kAll, e.lo, row_lane0 + i);
      }
    }

    // 3. FF weights exp22(s - m_new) in place, and the tile's row sums
    float ds[TR], dc[TR], dcc[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) ds[i] = dc[i] = dcc[i] = 0.0f;
#pragma unroll 1
    for (int j = 0; j < ns; ++j) {
      const int col = k0 + tx + KX * j;
      float* hp = ph + (tx + KX * j) * C::kQS + TR * ty;
      float* lp = pl + (tx + KX * j) * C::kQS + TR * ty;
      float xh[TR], xl[TR];
      lds<TR>(hp, xh);
      lds<TR>(lp, xl);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int pos = q_offset + q0 + ((TR * ty + i) >> hb_shift);
        const bool ok = col < Skv && (!causal || col <= pos);
        ff2 d = add212({xh[i], xl[i]}, -mn[i]);
        ff2 e = exp22_w(d.hi, d.lo);
        xh[i] = ok ? e.hi : 0.0f;
        xl[i] = ok ? e.lo : 0.0f;
        cascade(ds[i], dc[i], dcc[i], xh[i]);
        cascade(ds[i], dc[i], dcc[i], xl[i]);
      }
      sts<TR>(hp, xh);
      sts<TR>(lp, xl);
    }
    __syncwarp();   // the warp's weights are in ph / pl

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      // the row's sum: each lane's triple folded, then a shuffle tree
      ff2 t = two_sum(ds[i], dc[i]);
      ff2 f = fast_two_sum(t.hi, add(t.lo, dcc[i]));
#pragma unroll
      for (int off = 1; off < KX; off <<= 1) {
        const ff2 o = {__shfl_xor_sync(kAll, f.hi, off),
                       __shfl_xor_sync(kAll, f.lo, off)};
        const bool upper = (tx & off) != 0;
        f = add22(upper ? o : f, upper ? f : o);
      }
      ff2 dn = add22(mul22({dh[i], dl[i]}, {ah[i], al[i]}), f);
      dh[i] = dn.hi;
      dl[i] = dn.lo;
      m[i] = mn[i];
    }

    // 4. numerator: the p*v cascade over the keys [0, jn), a chunk of 64
    // head-dim cells at a time
#pragma unroll
    for (int cb = 0; cb < NC; ++cb) {
      float ps[TR][TK], pc[TR][TK], pcc[TR][TK];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TK; ++j) ps[i][j] = pc[i][j] = pcc[i][j] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < jn; ++j) {
        float xh[TR], xl[TR], vv[TK];
        lds<TR>(ph + j * C::kQS + TR * ty, xh);
        lds<TR>(pl + j * C::kQS + TR * ty, xl);
        lds<TK>(vs + j * HD + kBKV * cb + TK * tx, vv);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int e = 0; e < TK; ++e) {
            ff2 p = tp(xh[i], vv[e]);
            const float tl = add(p.lo, mul(xl[i], vv[e]));
            ff2 t = two_sum(ps[i][e], p.hi);
            ff2 u = two_sum(pc[i][e], t.lo);
            ps[i][e] = t.hi;
            pc[i][e] = u.hi;
            pcc[i][e] = add(add(pcc[i][e], u.lo), tl);
          }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int e = 0; e < TK; ++e) {
          ff2 pv = two_sum(ps[i][e], pc[i][e]);
          pv = fast_two_sum(pv.hi, add(pv.lo, pcc[i][e]));
          const int n = TK * cb + e;
          ff2 n1 = add22(mul22({nh[i][n], nl[i][n]}, {ah[i], al[i]}), pv);
          nh[i][n] = n1.hi;
          nl[i][n] = n1.lo;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = TR * ty + i, qi = q0 + (r >> hb_shift);
    if (qi >= Sq) continue;
    const int h = h0 + (r & (HB - 1));
    const bool ok = dh[i] > 1e-30f;
    const ff2 den = {ok ? dh[i] : 1e-30f, ok ? dl[i] : 0.0f};
    const size_t base = ((static_cast<size_t>(b) * Sq + qi) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < NC * TK; ++n) {
      const int d = kBKV * (n / TK) + TK * tx + n % TK;
      if (d < hd) {
        ff2 o = div22({nh[i][n], nl[i][n]}, den);
        out_hi[base + d] = o.hi;
        out_lo[base + d] = o.lo;
      }
    }
  }
}

template <class C, int HD, typename T>
int launch(const void* q, const void* k, const void* v, float* out_hi,
           float* out_lo, int B, int Sq, int Skv, int H, int KV, int hd,
           int causal, int q_offset, float scale, int hb_shift,
           cudaStream_t stream) {
  const int pb = C::kRows >> hb_shift;
  const long long groups = static_cast<long long>(B) * (H >> hb_shift);
  const long long n_qt = (static_cast<long long>(Sq) + pb - 1) / pb;
  if (pb < 1 || groups > 0x7fffffffLL || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups == 0 || n_qt == 0) return static_cast<int>(cudaGetLastError());
  const int smem = smem_floats<C, HD>() * static_cast<int>(sizeof(float));
  auto kern = ff_attention_kernel<C, HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(static_cast<unsigned>(groups), static_cast<unsigned>(n_qt)),
         C::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), out_hi, out_lo, Sq, Skv, H, KV, hd, causal,
      q_offset, scale, hb_shift, static_cast<int>(n_qt));
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int launch_plan(int plan, const void* q, const void* k, const void* v,
                float* out_hi, float* out_lo, int B, int Sq, int Skv, int H,
                int KV, int hd, int causal, int q_offset, float scale,
                int hb_shift, cudaStream_t stream) {
  switch (plan) {
    case 0:
      return launch<Big, HD, T>(q, k, v, out_hi, out_lo, B, Sq, Skv, H, KV, hd,
                            causal, q_offset, scale, hb_shift, stream);
    case 1:
      return launch<Small, HD, T>(q, k, v, out_hi, out_lo, B, Sq, Skv, H, KV,
                              hd, causal, q_offset, scale, hb_shift, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_hd(int plan, const void* q, const void* k, const void* v,
              float* out_hi, float* out_lo, int B, int Sq, int Skv, int H,
              int KV, int hd, int causal, int q_offset, float scale,
              int hb_shift, cudaStream_t stream) {
  switch (hd <= 64 ? 64 : hd) {
    case 64:
      return launch_plan<64, T>(plan, q, k, v, out_hi, out_lo, B, Sq, Skv,
                                H, KV, hd, causal, q_offset, scale,
                                hb_shift, stream);
    case 128:
      return launch_plan<128, T>(plan, q, k, v, out_hi, out_lo, B, Sq, Skv,
                                 H, KV, hd, causal, q_offset, scale,
                                 hb_shift, stream);
    case 192:
      return launch_plan<192, T>(plan, q, k, v, out_hi, out_lo, B, Sq, Skv,
                                 H, KV, hd, causal, q_offset, scale,
                                 hb_shift, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), contiguous, f32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1); out_hi, out_lo: (B, Sq, H, hd) f32.  hd: 1 to 64
// (the HD = 64 instance), 128 or 192.  plan: the tile configuration (0
// Big, 1 Small); hb_shift: log2 of the query heads a block (HB, which must
// divide H / KV).  Returns the CUDA error of the launch (0 on success).
extern "C" int ff_attention_fwd(const void* q, const void* k, const void* v,
                                float* out_hi, float* out_lo, int is_bf16,
                                int B, int Sq, int Skv, int H, int KV, int hd,
                                int causal, int q_offset, float scale,
                                int plan, int hb_shift, cudaStream_t stream) {
  if (hd < 1 || (hd > 64 && hd != 128 && hd != 192) || KV < 1 ||
      H % KV != 0 || hb_shift < 0 || hb_shift > 2 ||
      (H / KV) % (1 << hb_shift) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16
             ? launch_hd<__nv_bfloat16>(plan, q, k, v, out_hi, out_lo, B, Sq,
                                        Skv, H, KV, hd, causal, q_offset,
                                        scale, hb_shift, stream)
             : launch_hd<float>(plan, q, k, v, out_hi, out_lo, B, Sq, Skv, H,
                                KV, hd, causal, q_offset, scale, hb_shift,
                                stream);
}
