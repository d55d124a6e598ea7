// Device error-free transformations (EFTs) and FF operators shared by the
// port's CUDA kernels.  Counterparts of repro_torch/core/{transforms,ff,
// ffmath}.py with the same op sequences.
//
// Every add, subtract, multiply and divide is an explicitly rounded
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): the compiler
// never contracts those into an FMA, whatever the flags, so each rounded
// product that an EFT relies on stays rounded (the reference pins the same
// values with optimization barriers).  The build adds --fmad=false as a
// second guard for any plain operator.
#pragma once

#include <cuda_runtime.h>

namespace ffk {

struct ff2 {
  float hi, lo;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Add12 (Knuth TwoSum): s + r == a + b exactly.
__device__ __forceinline__ ff2 two_sum(float a, float b) {
  float s = add(a, b);
  float bb = sub(s, a);
  float err_b = sub(b, bb);
  float err_a = sub(a, sub(s, bb));
  return {s, add(err_a, err_b)};
}

// Dekker Fast2Sum: exact when |a| >= |b|.
__device__ __forceinline__ ff2 fast_two_sum(float a, float b) {
  float s = add(a, b);
  return {s, sub(b, sub(s, a))};
}

// Dekker split at s = 12 (4097 = 2^12 + 1).
__device__ __forceinline__ ff2 split(float a) {
  float c = mul(4097.0f, a);
  float a_big = sub(c, a);
  float a_hi = sub(c, a_big);
  return {a_hi, sub(a, a_hi)};
}

// Mul12 (Dekker TwoProd, no FMA): x + y == a * b exactly.
__device__ __forceinline__ ff2 two_prod(float a, float b) {
  float x = mul(a, b);
  ff2 as = split(a);
  ff2 bs = split(b);
  float err1 = sub(x, mul(as.hi, bs.hi));
  float err2 = sub(err1, mul(as.lo, bs.hi));
  float err3 = sub(err2, mul(as.hi, bs.lo));
  return {x, sub(mul(as.lo, bs.lo), err3)};
}

// Mul12 with an explicit fused multiply-add: y = fma(a, b, -x) is a * b - x
// rounded once, and that error is representable, so x + y == a * b exactly.
// Wherever two_prod above is exact (no overflow in its splits, no underflow
// in its partial products) both give the same (x, y): two instructions
// instead of seventeen.
__device__ __forceinline__ ff2 two_prod_fma(float a, float b) {
  float x = mul(a, b);
  return {x, __fmaf_rn(a, b, -x)};
}

// Paper Theorem 5 Add22 (branch-free sloppy variant).
__device__ __forceinline__ ff2 add22(ff2 a, ff2 b) {
  ff2 s = two_sum(a.hi, b.hi);
  float v = add(s.lo, add(a.lo, b.lo));
  return fast_two_sum(s.hi, v);
}

// FF + f32.
__device__ __forceinline__ ff2 add212(ff2 a, float b) {
  ff2 s = two_sum(a.hi, b);
  float v = add(s.lo, a.lo);
  return fast_two_sum(s.hi, v);
}

// Paper Theorem 6 Mul22.
__device__ __forceinline__ ff2 mul22(ff2 a, ff2 b) {
  ff2 t = two_prod(a.hi, b.hi);
  float u = add(t.lo, add(mul(a.hi, b.lo), mul(a.lo, b.hi)));
  return fast_two_sum(t.hi, u);
}

// FF * f32.
__device__ __forceinline__ ff2 mul212(ff2 a, float b) {
  ff2 t = two_prod(a.hi, b);
  float u = add(t.lo, mul(a.lo, b));
  return fast_two_sum(t.hi, u);
}

// FF division: hardware quotient as a seed plus one correction step.
__device__ __forceinline__ ff2 div22(ff2 a, ff2 b) {
  float ch = dvd(a.hi, b.hi);
  ff2 t = two_prod(ch, b.hi);
  float cl = dvd(sub(add(sub(sub(a.hi, t.hi), t.lo), a.lo), mul(ch, b.lo)),
                 b.hi);
  return fast_two_sum(ch, cl);
}

// ---------------------------------------------------------------------------
// Division by a small integer d (the erf series' n and 2n+1) without the
// IEEE division: __fdiv_rn is a reciprocal on the SFU (MUFU), FMAs, a range
// check (FCHK) and a branch to a slow path.  For odd d, with zh = RN(1/d)
// from the table below,
//
//   q0 = RN(a zh),  r = a - q0 d (one FMA, exact),  q = RN(q0 + r zh)
//
// is RN(a / d): q0 + r zh = a/d + e delta with e = a/d - q0 and |delta| <=
// 2^-24 (zh's error), so q is off a/d by ~2^-47 |a/d| (or ~2^-174 on the
// subnormal grid), while a/d lies at least ulp/(2d) from every rounding
// midpoint: a/d = A 2^j / d with A an integer, and a midpoint would need
// A 2^(j+1) = d (2M + 1), impossible for odd d.  r is computed as
// -(q0 d - a), so that a == -0 gives -0 (the FMA of opposite zeros is +0);
// a == +-inf gives q0 = +-inf (kept), NaN stays NaN.  An even d = m 2^k
// divides by m, then scales (div_int).  chip_smoke.py holds div_int and
// div22_int against __fdiv_rn and div22 for every f32 dividend and every
// divisor of the series; tests/test_torch_math_div.py emulates them
// exactly.
// ---------------------------------------------------------------------------

constexpr int kDivLimit = 120;          // divisors 1 .. 119
constexpr float kSplitSafe = 0x1p+100f;   // Dekker's split overflows ~2^116

// RN(1/d) for d = 1 .. 119 (entry 0 unused)
__constant__ float kRecip[kDivLimit] = {
    0.0f, 0x1p+0f, 0x1p-1f, 0x1.555556p-2f, 0x1p-2f, 0x1.99999ap-3f,
    0x1.555556p-3f, 0x1.24924ap-3f, 0x1p-3f, 0x1.c71c72p-4f, 0x1.99999ap-4f,
    0x1.745d18p-4f, 0x1.555556p-4f, 0x1.3b13b2p-4f, 0x1.24924ap-4f,
    0x1.111112p-4f, 0x1p-4f, 0x1.e1e1e2p-5f, 0x1.c71c72p-5f, 0x1.af286cp-5f,
    0x1.99999ap-5f, 0x1.861862p-5f, 0x1.745d18p-5f, 0x1.642c86p-5f,
    0x1.555556p-5f, 0x1.47ae14p-5f, 0x1.3b13b2p-5f, 0x1.2f684cp-5f,
    0x1.24924ap-5f, 0x1.1a7b96p-5f, 0x1.111112p-5f, 0x1.08421p-5f, 0x1p-5f,
    0x1.f07c2p-6f, 0x1.e1e1e2p-6f, 0x1.d41d42p-6f, 0x1.c71c72p-6f,
    0x1.bacf92p-6f, 0x1.af286cp-6f, 0x1.a41a42p-6f, 0x1.99999ap-6f,
    0x1.8f9c18p-6f, 0x1.861862p-6f, 0x1.7d05f4p-6f, 0x1.745d18p-6f,
    0x1.6c16c2p-6f, 0x1.642c86p-6f, 0x1.5c9882p-6f, 0x1.555556p-6f,
    0x1.4e5e0ap-6f, 0x1.47ae14p-6f, 0x1.414142p-6f, 0x1.3b13b2p-6f,
    0x1.3521dp-6f, 0x1.2f684cp-6f, 0x1.29e412p-6f, 0x1.24924ap-6f,
    0x1.1f7048p-6f, 0x1.1a7b96p-6f, 0x1.15b1e6p-6f, 0x1.111112p-6f,
    0x1.0c9714p-6f, 0x1.08421p-6f, 0x1.041042p-6f, 0x1p-6f, 0x1.f81f82p-7f,
    0x1.f07c2p-7f, 0x1.e9131ap-7f, 0x1.e1e1e2p-7f, 0x1.dae608p-7f,
    0x1.d41d42p-7f, 0x1.cd8568p-7f, 0x1.c71c72p-7f, 0x1.c0e07p-7f,
    0x1.bacf92p-7f, 0x1.b4e81cp-7f, 0x1.af286cp-7f, 0x1.a98ef6p-7f,
    0x1.a41a42p-7f, 0x1.9ec8eap-7f, 0x1.99999ap-7f, 0x1.948b1p-7f,
    0x1.8f9c18p-7f, 0x1.8acb9p-7f, 0x1.861862p-7f, 0x1.818182p-7f,
    0x1.7d05f4p-7f, 0x1.78a4c8p-7f, 0x1.745d18p-7f, 0x1.702e06p-7f,
    0x1.6c16c2p-7f, 0x1.681682p-7f, 0x1.642c86p-7f, 0x1.605816p-7f,
    0x1.5c9882p-7f, 0x1.58ed24p-7f, 0x1.555556p-7f, 0x1.51d07ep-7f,
    0x1.4e5e0ap-7f, 0x1.4afd6ap-7f, 0x1.47ae14p-7f, 0x1.446f86p-7f,
    0x1.414142p-7f, 0x1.3e22ccp-7f, 0x1.3b13b2p-7f, 0x1.381382p-7f,
    0x1.3521dp-7f, 0x1.323e34p-7f, 0x1.2f684cp-7f, 0x1.2c9fb4p-7f,
    0x1.29e412p-7f, 0x1.27350cp-7f, 0x1.24924ap-7f, 0x1.21fb78p-7f,
    0x1.1f7048p-7f, 0x1.1cf06ap-7f, 0x1.1a7b96p-7f, 0x1.181182p-7f,
    0x1.15b1e6p-7f, 0x1.135c82p-7f};

__device__ __forceinline__ float inf32() { return __int_as_float(0x7f800000); }

// div22 itself for a dividend beyond kSplitSafe, out of line: it runs only
// off the series' range, and inlined at each division of an unrolled
// series it would double the kernel's code.
__device__ __noinline__ ff2 div22_far(ff2 a, float d) {
  return div22(a, {d, 0.0f});
}

// RN(a / d) for an odd integer d = df >= 3 with zh = kRecip[d] and every
// f32 a: q0 + (a - q0 d) zh, keeping q0 = +-inf.  kFinite: for finite a
// only, without that test.
template <bool kFinite = false>
__device__ __forceinline__ float div_odd(float a, float df, float zh) {
  const float q0 = mul(a, zh);
  const float q = __fmaf_rn(-__fmaf_rn(q0, df, -a), zh, q0);
  return kFinite || fabsf(q0) != inf32() ? q : q0;
}

// RN(a / d) for an integer 1 <= d < kDivLimit and every f32 a.  With
// d = m 2^k (m odd): a itself for d = 1, an exact multiply for m = 1,
// div_odd for k = 0; else q = RN(q1 2^-k) of q1 = RN(a/m).  That second
// rounding is exact unless q is subnormal, and no float lies strictly
// between q1 and a/m, so q is RN(a/d) unless q1 2^-k is exactly a
// midpoint of the subnormal grid (e = q1 - q 2^k = +-2^(k-150)) while a/m
// is not q1: then RN(a/d) is the neighbour on a/m's side, the sign of
// r1 = a - q1 m.  The tests on d fold away where d is a constant (an
// unrolled loop).  kFinite: for finite a only.
template <bool kFinite = false>
__device__ __forceinline__ float div_int(float a, int d) {
  if (d == 1) return a;
  const int k = __ffs(d) - 1, m = d >> k;
  const float scale = kRecip[1 << k];                       // 2^-k
  if (m == 1) return mul(a, scale);
  const float mf = static_cast<float>(m);
  const float q1 = div_odd<kFinite>(a, mf, kRecip[m]);
  if (k == 0) return q1;
  const float q = mul(q1, scale);
  const float e = __fmaf_rn(-q, static_cast<float>(1 << k), q1);
  if (fabsf(e) == __int_as_float(1 << (k - 1))) {           // 2^(k-150)
    const float r1 = -__fmaf_rn(q1, mf, -a);
    if (r1 != 0.0f && (r1 > 0.0f) == (e > 0.0f))
      return __fmaf_rn(e, 2.0f * scale, q);
  }
  return q;
}

// div22(a, {d, 0}) bit for bit, `div` an exact x -> RN(x / d) for both of
// its divisions: the same quotient ch, then t = two_prod_fma(ch, d).
// Dekker's two_prod(ch, d) has the same exact value below kSplitSafe (d
// needs 7 bits, so no partial product rounds); only a zero t.lo may
// differ in sign.  x1 = a.hi - t.hi is never -0 (a.hi == -0 gives t.hi ==
// -0), so x2 = x1 - t.lo is the same for either zero and never -0, x3 =
// x2 + a.lo is never -0, and div22's x3 - ch * b.lo (b.lo = 0, ch finite)
// is x3: that step is dropped.  Beyond kSplitSafe (and for inf or NaN) it
// is div22 itself.  kBounded: for finite limbs with |a.hi| < kSplitSafe
// only (erf's series on normalised arguments), without those tests.
template <bool kBounded, typename Div>
__device__ __forceinline__ ff2 div22_by(ff2 a, float df, Div div) {
  const float ch = div(a.hi);
  if (!kBounded && !(fabsf(ch) < kSplitSafe)) return div22_far(a, df);
  const ff2 t = two_prod_fma(ch, df);
  const float cl = div(add(sub(sub(a.hi, t.hi), t.lo), a.lo));
  return fast_two_sum(ch, cl);
}

// div22(a, {d, 0}) for an integer 1 <= d < kDivLimit.
template <bool kBounded = false>
__device__ __forceinline__ ff2 div22_int(ff2 a, int d) {
  return div22_by<kBounded>(a, static_cast<float>(d), [=](float x) {
    return div_int<kBounded>(x, d);
  });
}

// div22(a, {d, 0}) for an odd d = df >= 3, zh = kRecip[d].
template <bool kBounded = false>
__device__ __forceinline__ ff2 div22_odd(ff2 a, float df, float zh) {
  return div22_by<kBounded>(a, df, [=](float x) {
    return div_odd<kBounded>(x, df, zh);
  });
}

// FF square root: one Newton correction of the correctly rounded f32 root.
__device__ __forceinline__ ff2 sqrt22(ff2 a) {
  float ch = __fsqrt_rn(a.hi);
  ff2 t = two_prod(ch, ch);
  float num = add(sub(sub(a.hi, t.hi), t.lo), a.lo);
  float cl = dvd(num, add(ch, ch));
  return fast_two_sum(ch, cl);
}

// a*b + c in FF with one renormalisation.
__device__ __forceinline__ ff2 fma22(ff2 a, ff2 b, ff2 c) {
  ff2 t = two_prod(a.hi, b.hi);
  float u = add(t.lo, add(mul(a.hi, b.lo), mul(a.lo, b.hi)));
  ff2 s = two_sum(t.hi, c.hi);
  float v = add(s.lo, add(u, c.lo));
  return fast_two_sum(s.hi, v);
}

// ---------------------------------------------------------------------------
// The TPU kernels' 128-lane compensated row sum (_lane_cascade and
// _fold_lanes in repro/kernels/ff_fused.py): lane l folds columns l,
// l+128, ... in order into a Neumaier triple (s, c, cc), then the 128
// triples are folded in lane order.  Every whole-row kernel sums in this
// order, so it gets its plain version's bits.
// ---------------------------------------------------------------------------

constexpr int kLanes = 128;

struct LaneSum {
  float s = 0.0f, c = 0.0f, cc = 0.0f;
  __device__ __forceinline__ void add(float x) {
    ff2 t = two_sum(s, x);
    ff2 u = two_sum(c, t.lo);
    s = t.hi;
    c = u.hi;
    cc = ffk::add(cc, u.lo);
  }
};

// The FF sum of the block's `lanes` lanes (one thread each, lane 0
// first), to every thread.  Called by all `lanes` threads of the block;
// sh is 3 * lanes + 2 floats of shared memory, reusable by the next call.
__device__ __forceinline__ ff2 fold_lanes_n(const LaneSum& ln, float* sh,
                                            int lanes) {
  const int lane = threadIdx.x;
  __syncthreads();                 // the previous fold has read sh
  sh[lane] = ln.s;
  sh[lanes + lane] = ln.c;
  sh[2 * lanes + lane] = ln.cc;
  __syncthreads();
  if (lane == 0) {
    float fh = 0.0f, fl = 0.0f;
    for (int i = 0; i < lanes; ++i) {
      ff2 t = two_sum(fh, sh[i]);
      float v = add(t.lo, add(add(fl, sh[lanes + i]), sh[2 * lanes + i]));
      ff2 f = fast_two_sum(t.hi, v);
      fh = f.hi;
      fl = f.lo;
    }
    sh[3 * lanes] = fh;
    sh[3 * lanes + 1] = fl;
  }
  __syncthreads();
  return {sh[3 * lanes], sh[3 * lanes + 1]};
}

// The TPU kernels' fold: fold_lanes_n over kLanes lanes.
__device__ __forceinline__ ff2 fold_lanes(const LaneSum& ln, float* sh) {
  return fold_lanes_n(ln, sh, kLanes);
}

// ---------------------------------------------------------------------------
// The FF elementary functions of repro/core/ffmath.py: exp22, expm122,
// log22, log1p22, tanh22, sigmoid22, erf22, gelu22, silu22 and pow22
// (same constants, same op order).  Constants are the f32 values of the
// reference's, written as hex floats so that no decimal rounding differs.
// The reference evaluates every branch and selects with jnp.where; these
// branch, and return the value its selection picks.
// ---------------------------------------------------------------------------

constexpr float kExpClipLo = -105.0f, kExpClipHi = 89.0f;
constexpr float kIdentity = 0x1p-45f;   // f(x) == x at FF precision below

__device__ __forceinline__ float exp2i(int k) {
  // exact 2^k for k in [-126, 127], from exponent bits
  return __int_as_float((k + 127) << 23);
}

__device__ __forceinline__ ff2 scale2k(float h, float l, int k) {
  int k1 = k >> 1;
  int k2 = k - k1;
  float s1 = exp2i(k1), s2 = exp2i(k2);
  return {mul(mul(h, s1), s2), mul(mul(l, s1), s2)};
}

// The exp kernel's two halves (defined after exp22, which states them):
// the Cody–Waite reduction and the expm1 polynomial.
__device__ __forceinline__ ff2 exp_reduce(float xh, float xl, int* k);
__device__ __forceinline__ ff2 exp_poly(ff2 r);

// FF exp of an FF argument: inf above ~88.72, 0 below ~-103.
__device__ __forceinline__ ff2 exp22(float xh, float xl) {
  int k;
  ff2 r = exp_reduce(xh, xl, &k);
  ff2 em1 = exp_poly(r);
  ff2 p = add212(em1, 1.0f);
  ff2 e = scale2k(p.hi, p.lo, k);
  bool big = xh > kExpClipHi;
  bool tiny = xh < kExpClipLo;
  float eh = big ? inf32() : (tiny ? 0.0f : e.hi);
  float el = (big || tiny || eh == inf32()) ? 0.0f : e.lo;
  if (xh != xh) return {xh, xh};
  return {eh, el};
}

// Cody–Waite reduction x = k*ln2 + r, r an FF pair, |r| <= ln2/2
// (jnp.clip / jnp.round).
__device__ __forceinline__ ff2 exp_reduce(float xh, float xl, int* k) {
  const float INV_LN2 = 0x1.715476p+0f;
  const float L1 = 0x1.62e4p-1f;     // 45426 * 2^-16
  const float L2 = 0x1.7f7ep-20f;    // 49087 * 2^-35
  const float L3 = -0x1.c610cap-37f;
  float xc = fminf(fmaxf(xh, kExpClipLo), kExpClipHi);
  float kf = rintf(mul(xc, INV_LN2));           // round half to even
  float h1 = sub(xc, mul(kf, L1));              // exact
  ff2 s = two_sum(h1, -mul(kf, L2));
  float v = sub(xl, mul(kf, L3));
  *k = static_cast<int>(kf);
  return add212(s, v);
}

// expm1(r) = r + r^2 W(r) on |r| <= ln2/2.
__device__ __forceinline__ ff2 exp_poly(ff2 r) {
  // f32 Horner tail of W, degrees 6..11 (W_F32[0..5])
  const float W_F32[6] = {0x1.a01a02p-16f, 0x1.71de3ap-19f, 0x1.27e4fcp-22f,
                          0x1.ae6456p-26f, 0x1.1eed8ep-29f, 0x1.612462p-33f};
  // FF coefficients of W, degrees 0..5
  const float W_H[6] = {0x1p-1f, 0x1.555556p-3f, 0x1.555556p-5f,
                        0x1.111112p-7f, 0x1.6c16c2p-10f, 0x1.a01a02p-13f};
  const float W_L[6] = {0.0f, -0x1.555556p-28f, -0x1.555556p-30f,
                        -0x1.dddddep-32f, -0x1.27d27ep-35f,
                        -0x1.7f97fap-39f};
  float t = W_F32[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) t = add(mul(t, r.hi), W_F32[i]);
  ff2 w = {t, 0.0f};
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    w = mul22(w, r);
    w = add22(w, {W_H[j], W_L[j]});
  }
  ff2 z = mul22(r, r);
  ff2 q = mul22(z, w);
  return add22(r, q);
}

// FF expm1: the exp kernel without the +1 where k == 0, exp(x) - 1
// beyond; x itself below 2^-45.  kNonZeroK: for a caller whose xh is
// below -0.7 (or nan): the reduction's k = rint(xh / ln2) is then at most
// -1 (nan is clamped to -105 first, and returns early), so the k == 0
// select is dropped (tanh's large band: xh = -2|x| < -0.7).
template <bool kNonZeroK = false>
__device__ __forceinline__ ff2 expm122(float xh, float xl) {
  int k;
  ff2 r = exp_reduce(xh, xl, &k);
  ff2 s = exp_poly(r);
  ff2 p = add212(s, 1.0f);
  ff2 e = scale2k(p.hi, p.lo, k);
  ff2 g = add212(e, -1.0f);
  bool ovf = e.hi == inf32();
  ff2 o = (!kNonZeroK && k == 0) ? s
                                 : ff2{ovf ? e.hi : g.hi, ovf ? 0.0f : g.lo};
  if (fabsf(xh) < kIdentity) o = {xh, xl};
  bool big = xh > kExpClipHi;
  bool tiny = xh < kExpClipLo;
  if (big || tiny) o = {big ? inf32() : -1.0f, 0.0f};
  if (xh != xh) return {xh, xh};
  return o;
}

// The atanh kernel of log and log1p (defined after log_core, which states
// it).
__device__ __forceinline__ ff2 atanh_poly(ff2 s);

// log(2^e m) = e ln2 + 2 s S(s^2), s = (m-1)/(m+1), m in [1/sqrt2, sqrt2).
__device__ __forceinline__ ff2 log_core(ff2 m, float ef) {
  const float LN2_H = 0x1.62e43p-1f;   // ln2 as an FF constant
  const float LN2_L = -0x1.05c61p-29f;
  ff2 n = add212(m, -1.0f);
  ff2 d = add212(m, 1.0f);
  ff2 s = div22(n, d);
  ff2 a = atanh_poly(s);
  ff2 l = mul22(s, a);
  l = {mul(2.0f, l.hi), mul(2.0f, l.lo)};       // exact
  ff2 tl = mul212({LN2_H, LN2_L}, ef);
  return add22(tl, l);
}

// S(z) = sum z^n / (2n+1) at z = s^2 <= 0.0295: FF Horner n = 3..0 over
// an f32 tail n = 9..4 (the atanh kernel of log and log1p).
__device__ __forceinline__ ff2 atanh_poly(ff2 s) {
  const float S_F32[6] = {0x1.c71c72p-4f, 0x1.745d18p-4f, 0x1.3b13b2p-4f,
                          0x1.111112p-4f, 0x1.e1e1e2p-5f, 0x1.af286cp-5f};
  const float S_H[4] = {0x1p+0f, 0x1.555556p-2f, 0x1.99999ap-3f,
                        0x1.24924ap-3f};
  const float S_L[4] = {0.0f, -0x1.555556p-27f, -0x1.99999ap-29f,
                        -0x1.b6db6ep-28f};
  ff2 z = mul22(s, s);
  float t = S_F32[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) t = add(mul(t, z.hi), S_F32[i]);
  ff2 a = {t, 0.0f};
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    a = mul22(a, z);
    a = add22(a, {S_H[j], S_L[j]});
  }
  return a;
}

// FF natural log: nan for x < 0, -inf at x == 0.
__device__ __forceinline__ ff2 log22(float xh, float xl) {
  // frexp to [1/sqrt2, sqrt2) by exponent-bit surgery
  int bits = __float_as_int(xh);
  int e = ((bits >> 23) & 0xFF) - 127;
  float mh = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  bool big = mh > 0x1.6a09e6p+0f;
  mh = big ? mul(mh, 0.5f) : mh;
  e += big ? 1 : 0;
  float ml = scale2k(xl, 0.0f, -e).hi;
  ff2 r = log_core({mh, ml}, static_cast<float>(e));
  bool bad = (xh < 0.0f) || (xh != xh);
  float rh = xh == 0.0f ? -inf32() : (bad ? __int_as_float(0x7fc00000) : r.hi);
  rh = xh == inf32() ? inf32() : rh;
  float rl = (xh == 0.0f || bad || xh == inf32()) ? 0.0f : r.lo;
  return {rh, rl};
}

// tanh's bands, the costliest first (the order a band sort runs them):
// which branch tanh22 takes.
enum TanhBand : int { kTanhLarge, kTanhSmall, kTanhIdentity, kTanhBands };

// The band of hi limb xh: nan goes to the large band, as in tanh22.
__device__ __forceinline__ int tanh_band(float xh) {
  if (fabsf(xh) < kIdentity) return kTanhIdentity;
  return fabsf(xh) <= 0x1.666666p-2f ? kTanhSmall : kTanhLarge;   // 0.35
}

// tanh's Maclaurin branch, x p(x^2), on |x| <= 0.35.
__device__ __forceinline__ ff2 tanh_small(float xh, float xl) {
  const float C_F32[6] = {0x1.d6d3dp-9f, -0x1.7da364p-10f, 0x1.355824p-11f,
                          -0x1.f57d78p-13f, 0x1.967e18p-14f,
                          -0x1.497d8ep-15f};
  const float C_H[6] = {0x1p+0f, -0x1.555556p-2f, 0x1.111112p-3f,
                        -0x1.ba1ba2p-5f, 0x1.664f48p-6f, -0x1.226e36p-7f};
  const float C_L[6] = {0.0f, 0x1.555556p-27f, -0x1.dddddep-28f,
                        0x1.17917ap-31f, 0x1.058220p-31f, 0x1.4327b8p-32f};
  ff2 x = {xh, xl};
  ff2 z = mul22(x, x);
  float t = C_F32[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) t = add(mul(t, z.hi), C_F32[i]);
  ff2 p = {t, 0.0f};
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    p = mul22(p, z);
    p = add22(p, {C_H[j], C_L[j]});
  }
  return mul22(x, p);
}

// tanh's branch beyond 0.35 (nan and +-inf too): sgn(x) (-t / (2 + t)),
// t = expm1(-2|x|); -2|x| < -0.7 there, so expm1's k is never 0.
__device__ __forceinline__ ff2 tanh_large(float xh, float xl) {
  float sgn = xh < 0.0f ? -1.0f : 1.0f;
  float m2 = mul(-2.0f, sgn);
  ff2 th = expm122<true>(mul(m2, xh), mul(m2, xl));
  ff2 d = add212(th, 2.0f);
  ff2 q = div22({-th.hi, -th.lo}, d);
  return {mul(sgn, q.hi), mul(sgn, q.lo)};
}

// FF tanh: odd Maclaurin kernel on |x| <= 0.35, -t/(2+t) with
// t = expm1(-2|x|) beyond; x itself below 2^-45.  Only the branch the
// element takes is evaluated: the value the reference's selection picks.
__device__ __forceinline__ ff2 tanh22(float xh, float xl) {
  switch (tanh_band(xh)) {
    case kTanhIdentity: return {xh, xl};
    case kTanhSmall: return tanh_small(xh, xl);
    default: return tanh_large(xh, xl);
  }
}

// FF logistic sigmoid, u / (1 + z), z = exp(-|x|), u = 1 for x >= 0 and
// z otherwise.
__device__ __forceinline__ ff2 sigmoid22(float xh, float xl) {
  float ns = xh < 0.0f ? 1.0f : -1.0f;          // -sgn
  ff2 z = exp22(mul(ns, xh), mul(ns, xl));
  ff2 d = add212(z, 1.0f);
  ff2 n = xh >= 0.0f ? ff2{1.0f, 0.0f} : z;
  ff2 r = div22(n, d);
  if (xh != xh) return {xh, xh};
  return r;
}

// FF log1p: 2 atanh(x / (2 + x)) from x itself on the near branch
// (x in [-0.2929, 0.4142]), log of the exact 1 + x beyond; x itself
// below 2^-45.
__device__ __forceinline__ ff2 log1p22(float xh, float xl) {
  if (xh != xh) return {xh, xh};
  if (xh == inf32()) return {inf32(), 0.0f};
  if (fabsf(xh) < kIdentity) return {xh, xl};
  if (xh >= -0x1.2bec32p-2f && xh <= 0x1.a82798p-2f) {
    ff2 d = add212({xh, xl}, 2.0f);
    ff2 s = div22({xh, xl}, d);
    ff2 n = mul22(s, atanh_poly(s));
    return {mul(2.0f, n.hi), mul(2.0f, n.lo)};
  }
  ff2 w = two_sum(xh, 1.0f);
  ff2 f = fast_two_sum(w.hi, add(w.lo, xl));
  return log22(f.hi, f.lo);
}

constexpr float kTwoOverSqrtPiH = 0x1.20dd76p+0f, kTwoOverSqrtPiL =
    -0x1.f7ac92p-25f;

constexpr int kErfAltTerms = 17;   // n = 1..16 after the n = 0 seed
constexpr int kErfPosTerms = 60;   // n = 1..59 after the n = 0 seed

// erf on |x| <= 1: the alternating Maclaurin sum (2/sqrt pi) x sum_n
// (-1)^n (x^2)^n / (n! (2n+1)), every term update in FF; each division by
// n and by 2n+1 an exact div22_int.  kBounded: |xl| <= |xh|, so every
// term stays below 2^4 (see erf22).
template <bool kBounded>
__device__ __forceinline__ ff2 erf_small(float xh, float xl) {
  ff2 x = {xh, xl};
  ff2 z = mul22(x, x);
  ff2 u = {1.0f, 0.0f}, a = {1.0f, 0.0f};
#pragma unroll
  for (int n = 1; n < kErfAltTerms; ++n) {
    u = mul22(u, z);
    u = div22_int<kBounded>(u, n);                        // z^n / n!
    ff2 t = div22_int<kBounded>(u, 2 * n + 1);
    a = add22(a, (n & 1) ? ff2{-t.hi, -t.lo} : t);
  }
  return mul22(mul22(x, a), {kTwoOverSqrtPiH, kTwoOverSqrtPiL});
}

// erf on 1 < x <= 4: the positive (Kummer) series (2x/sqrt pi) e^{-x^2}
// sum_n (2x^2)^n / (2n+1)!!; each division by 2n+1 an exact div22_odd.
// kBounded: |axl| <= axh, so every term stays below 2^85 (see erf22).
template <bool kBounded>
__device__ __forceinline__ ff2 erf_mid(float axh, float axl) {
  ff2 ax = {axh, axl};
  ff2 z = mul22(ax, ax);
  ff2 v = {mul(2.0f, z.hi), mul(2.0f, z.lo)};    // exact
  ff2 t = {1.0f, 0.0f}, a = {1.0f, 0.0f};
  float d = 1.0f;
#pragma unroll 4
  for (int n = 1; n < kErfPosTerms; ++n) {
    d = add(d, 2.0f);                                      // 2n + 1, exact
    t = mul22(t, v);
    t = div22_odd<kBounded>(t, d, kRecip[2 * n + 1]);
    a = add22(a, t);
  }
  ff2 e = exp22(-z.hi, -z.lo);
  ff2 g = mul22(mul22(ax, e), a);
  return mul22(g, {kTwoOverSqrtPiH, kTwoOverSqrtPiL});
}

// The series for any limbs (a lo limb larger than hi), out of line.
__device__ __noinline__ ff2 erf_small_any(float xh, float xl) {
  return erf_small<false>(xh, xl);
}
__device__ __noinline__ ff2 erf_mid_any(float axh, float axl) {
  return erf_mid<false>(axh, axl);
}

// erf on x > 4: 1 - e^{-x^2} A(w) / (x sqrt pi), w = 1/(2x^2), A the
// asymptotic erfc series by an f32 Horner.
__device__ __forceinline__ ff2 erf_big(float axh, float axl) {
  const float ASY[13] = {0x1p+0f, -0x1p+0f, 0x1.8p+1f, -0x1.ep+3f,
                         0x1.a4p+6f, -0x1.d88p+9f, 0x1.44d8p+13f,
                         -0x1.07ef8p+17f, 0x1.eee11p+20f, -0x1.06e79p+25f,
                         0x1.3832fcp+29f, -0x1.99c2eap+33f,
                         0x1.268418p+38f};
  ff2 ax = {axh, axl};
  ff2 z = mul22(ax, ax);
  float w = dvd(0.5f, z.hi);
  float a = ASY[12];
#pragma unroll
  for (int k = 11; k >= 0; --k) a = add(mul(a, w), ASY[k]);
  ff2 e = exp22(-z.hi, -z.lo);
  ff2 u = mul212(e, a);
  ff2 d = mul22(ax, {0x1.c5bf8ap+0f, -0x1.c96212p-25f});   // x sqrt pi
  ff2 c = div22(u, d);                                     // erfc
  return add212({-c.hi, -c.lo}, 1.0f);
}

// FF error function: the alternating series on |x| <= 1, the positive
// series to 4, the asymptotic erfc beyond; |x| clamped at 30 (erf == 1
// there at FF precision), erf(+-0) = +-0.
__device__ __forceinline__ ff2 erf22(float xh, float xl) {
  if (xh != xh) return {xh, xh};
  if (xh == 0.0f) return {xh, 0.0f};
  const float sgn = xh < 0.0f ? -1.0f : 1.0f;
  float axh = mul(sgn, xh), axl = mul(sgn, xl);
  if (axh > 30.0f) axl = 0.0f;
  axh = fminf(axh, 30.0f);
  // |xl| <= |xh| (a normalised argument) bounds every term of the series:
  // |x| <= 2 on the small band, <= 8 on the mid band
  const bool bounded = fabsf(xl) <= fabsf(xh);
  if (axh <= 1.0f)                                // odd: sign built in
    return bounded ? erf_small<true>(xh, xl) : erf_small_any(xh, xl);
  ff2 r = axh > 4.0f ? erf_big(axh, axl)
                     : (bounded ? erf_mid<true>(axh, axl)
                                : erf_mid_any(axh, axl));
  return {mul(sgn, r.hi), mul(sgn, r.lo)};
}

// The bands of erf22 and gelu22, in the order the ff_math kernel runs them
// (the costliest first): which series an argument takes.
enum ErfBand : int { kErfMid, kErfSmall, kErfBig, kErfRest, kErfBands };

__device__ __forceinline__ int erf_band(float xh) {
  const float a = fabsf(xh);
  if (!(a > 0.0f)) return kErfRest;               // nan, +-0
  return a <= 1.0f ? kErfSmall : (a <= 4.0f ? kErfMid : kErfBig);
}

// FF exact-form GELU, 0.5 x (1 + erf(x / sqrt2)); gelu(+-0) = +-0,
// gelu(-inf) = 0, gelu(inf) = inf.
__device__ __forceinline__ ff2 gelu22(float xh, float xl) {
  if (xh == 0.0f) return {xh, 0.0f};
  if (xh == -inf32()) return {0.0f, 0.0f};
  if (xh == inf32()) return {inf32(), 0.0f};
  ff2 x = {xh, xl};
  ff2 v = mul22(x, {0x1.6a09e6p-1f, 0x1.9fcef4p-27f});     // x / sqrt2
  ff2 o = add212(erf22(v.hi, v.lo), 1.0f);
  ff2 r = mul22(x, o);
  return {mul(0.5f, r.hi), mul(0.5f, r.lo)};               // exact
}

// erf_band of gelu22's erf argument x / sqrt2; its rails in kErfRest.
__device__ __forceinline__ int gelu_band(float xh, float xl) {
  if (xh == 0.0f || fabsf(xh) == inf32()) return kErfRest;
  return erf_band(mul22({xh, xl}, {0x1.6a09e6p-1f, 0x1.9fcef4p-27f}).hi);
}

// FF SiLU, x * sigmoid(x), with gelu22's rules at +-0 and +-inf.
__device__ __forceinline__ ff2 silu22(float xh, float xl) {
  if (xh == 0.0f) return {xh, 0.0f};
  if (xh == -inf32()) return {0.0f, 0.0f};
  if (xh == inf32()) return {inf32(), 0.0f};
  return mul22({xh, xl}, sigmoid22(xh, xl));
}

// FF a**b = exp(b log a): nan for a < 0; the IEEE limits at a in {0, inf};
// b == 0 gives 1, last (0**0 == 1).  The selections in the reference's
// order.
__device__ __forceinline__ ff2 pow22(float ah, float al, float bh,
                                     float bl) {
  ff2 l = log22(ah, al);
  ff2 t = mul22(l, {bh, bl});
  ff2 r = exp22(t.hi, t.lo);
  if (ah == 0.0f || ah == inf32()) {
    const bool zero = ah == 0.0f;
    if (bh > 0.0f) r.hi = zero ? 0.0f : inf32();
    if (bh < 0.0f) r.hi = zero ? inf32() : 0.0f;
    r.lo = 0.0f;
  }
  if (bh == 0.0f) r = {1.0f, 0.0f};
  return r;
}

// ---------------------------------------------------------------------------
// sigmoid22 and silu22 bit for bit, on the FMA TwoProd (the ff_math kernel's
// SIGMOID and SILU instances).  Dekker's two_prod costs 17 instructions,
// two_prod_fma 2, and where Dekker's is exact both give the same (x, y)
// value; these paths run ten of them an element.  The twins below are named
// *_fma rather than a template parameter of mul22, div22 and exp_poly: the
// Dekker forms that every other kernel calls stay as they are.
//
// Exactness.  Dekker's two_prod(a, b) is exact when neither split overflows
// (|a|, |b| < 2^115) and no partial product underflows: a_lo b_lo is a
// multiple of 2^(ea + eb - 46) (ea, eb the exponents), on the f32 grid for
// ea + eb >= -103, which |a b| >= 2^-100 ensures.  The products, for an
// element whose reduced argument r = exp_reduce(-|x|) has |r.hi| <= 1/2:
//   - exp_poly's Horner, w.hi r.hi: w.hi in [2^-16, 1] (W's coefficients
//     and |r| <= 1/2), so |r.hi| >= 2^-48 gives >= 2^-64;
//   - r.hi r.hi >= 2^-96, and z.hi w.hi >= 2^-98 (w.hi ~ W(r) >= 0.4);
//   - div22's ch d.hi, d = 1 + z, z = exp(-|x|) in [0, 1.65]: d.hi == 1
//     where z.hi < 2^-25, and Dekker's split of 1 is (1, 0), so its
//     partial products are ch's halves themselves, exact for any ch,
//     subnormal too; else ch d.hi ~ n.hi >= z.hi >= 2^-25;
//   - silu's x.hi s.hi: tested on its rounded product, 2^-100 <= |t.hi| <
//     2^100.  Then both operands are normal and below 2^115: s.hi <= 1;
//     for x > 0, s.hi >= 0.37, so |x.hi| < 2^102; for x < 0, s > 0 only
//     above x = -105, so s.hi >= 2^-100 / 105.
// r.hi == 0 (x = +-0, or an FF x that cancels k ln2) makes those products
// zero: exact too.  So an element takes this path where |r.hi| <= 1/2 and
// (|r.hi| >= 2^-48 or r.hi == 0), and for silu where t.hi passes its test;
// nan and +-inf pass through the same selections as in exp22 and sigmoid22
// (their r comes from the clamped argument).  Every other element runs
// sigmoid22 / silu22 itself, out of line (like div22_far): |x| below
// 2^-48 (where r is x), r.hi cancelled below 2^-48, silu's |x s| below
// 2^-100 (x below ~-73.6), limbs that break |r.hi| <= 1/2.
//
// Signed zeros.  Where the exact product is an f32, two_prod_fma gives
// y = +0, while Dekker's y = a_lo b_lo - err3 is -0 when one split low half
// is +0 (a_lo == a - a_hi is never -0) and the other negative.  At a Mul22
// that zero enters u = y + (a.hi b.lo + a.lo b.hi), which differs only if
// the sum of the cross products is -0, and then only in the sign of the
// output's lo limb.  Where each such lo limb goes:
//   - Horner steps: into add22(w, {W_H[j], W_L[j]}), whose w.lo + W_L[j] is
//     W_L[j] for j > 0, and +0 for W_L[0] == +0: gone;
//   - r r: a square's split halves are equal, so Dekker's y is +0: none;
//   - z w: into add22(r, q), then into exp22's add212(em1, 1), whose
//     TwoSum with 1 has an error of +0 or nonzero, so the lo limb's sum with
//     it drops the sign: gone;
//   - div22: x1 = a.hi - t.hi is never -0, so x1 - t.lo is the same for
//     either zero (as in div22_by): gone;
//   - silu's x s: its lo limb is the output's.  There u == 0 sends the
//     element to silu22 (one test; no input found that reaches it, but
//     the operands {-(1 + 2^-23), -0} and {0.5, +0} show the pattern).
// tests/test_torch_math_fma.py emulates this path exactly on the CPU and
// holds it to sigmoid22 and silu22 on these inputs' classes.
// ---------------------------------------------------------------------------

// Mul22 and Div22 on two_prod_fma.
__device__ __forceinline__ ff2 mul22_fma(ff2 a, ff2 b) {
  ff2 t = two_prod_fma(a.hi, b.hi);
  float u = add(t.lo, add(mul(a.hi, b.lo), mul(a.lo, b.hi)));
  return fast_two_sum(t.hi, u);
}

__device__ __forceinline__ ff2 div22_fma(ff2 a, ff2 b) {
  float ch = dvd(a.hi, b.hi);
  ff2 t = two_prod_fma(ch, b.hi);
  float cl = dvd(sub(add(sub(sub(a.hi, t.hi), t.lo), a.lo), mul(ch, b.lo)),
                 b.hi);
  return fast_two_sum(ch, cl);
}

// exp_poly on mul22_fma (the same constants and op order).
__device__ __forceinline__ ff2 exp_poly_fma(ff2 r) {
  const float W_F32[6] = {0x1.a01a02p-16f, 0x1.71de3ap-19f, 0x1.27e4fcp-22f,
                          0x1.ae6456p-26f, 0x1.1eed8ep-29f, 0x1.612462p-33f};
  const float W_H[6] = {0x1p-1f, 0x1.555556p-3f, 0x1.555556p-5f,
                        0x1.111112p-7f, 0x1.6c16c2p-10f, 0x1.a01a02p-13f};
  const float W_L[6] = {0.0f, -0x1.555556p-28f, -0x1.555556p-30f,
                        -0x1.dddddep-32f, -0x1.27d27ep-35f,
                        -0x1.7f97fap-39f};
  float t = W_F32[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) t = add(mul(t, r.hi), W_F32[i]);
  ff2 w = {t, 0.0f};
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    w = mul22_fma(w, r);
    w = add22(w, {W_H[j], W_L[j]});
  }
  ff2 z = mul22_fma(r, r);
  ff2 q = mul22_fma(z, w);
  return add22(r, q);
}

// exp22 on exp_poly_fma; *ok: its reduced argument is in the domain above.
__device__ __forceinline__ ff2 exp22_fma(float xh, float xl, bool* ok) {
  int k;
  ff2 r = exp_reduce(xh, xl, &k);
  const float ar = fabsf(r.hi);
  *ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);
  ff2 em1 = exp_poly_fma(r);
  ff2 p = add212(em1, 1.0f);
  ff2 e = scale2k(p.hi, p.lo, k);
  bool big = xh > kExpClipHi;
  bool tiny = xh < kExpClipLo;
  float eh = big ? inf32() : (tiny ? 0.0f : e.hi);
  float el = (big || tiny || eh == inf32()) ? 0.0f : e.lo;
  if (xh != xh) return {xh, xh};
  return {eh, el};
}

// ---------------------------------------------------------------------------
// expm122 bit for bit on the FMA TwoProd (the ff_math kernel's EXPM1
// instance): the kNonZeroK = false form's op order and selections on
// exp_poly_fma, exp22_fma's test, and expm122 itself where it fails.  8
// TwoProds an element.
//
// Exactness.  The products are exp22's (above): the Horner's w.hi r.hi, r.hi
// r.hi and z.hi w.hi, exact where |r.hi| <= 1/2 and (|r.hi| >= 2^-48 or r.hi
// == 0); nothing else multiplies two variables.  On the k == 0 branch |x| is
// at most ~ln2/2 and r is x to within the reduction's rounding, so r.hi is
// ~x.hi >= 2^-45 wherever the identity branch is not taken; r cancels below
// 2^-48 only for an FF x within 2^-48 of k ln2 (k != 0) or whose lo nearly
// cancels hi, and lo limbs beyond hi break |r.hi| <= 1/2: those elements
// run expm122.
//
// The test is conservative here: no FF x is known where the bare FMA
// form's output differs from expm122's (test_expm1_guard_is_conservative
// in tests/test_torch_math_fma.py).  On the k == 0 branch, whose output is
// exp_poly(r) itself, an element fails it only (i) with lo beyond hi,
// |r.hi| > 1/2, where Dekker's products stay exact until its split
// overflows near 2^115, and there r r overflows and both forms give nan;
// or (ii) with 0 < |r.hi| < 2^-48 from a lo that cancels hi (|xh| >=
// 2^-45): r = xh + xl is then exact (r.lo = 0), a multiple of 2^-69 with
// at most 21 bits, W(r)'s hi is W_H[0] = 1/2, and every value in Dekker's
// products is a multiple of 2^-138 of at most 24 bits, so exact.  For k
// != 0 a product's error differs below 2^-126, far under the rounding of
// 1 + s.  It stays exp22_fma's test, whose proof is the one that holds:
// it costs nothing where it passes (no element of the timed inputs fails
// it).
//
// Signed zeros.  On that domain exp_poly_fma(r) is exp_poly(r) bit for bit,
// the signs of zeros included, so both branches are expm122's: k == 0
// returns s itself (no +1 to absorb a sign, unlike exp22), and k != 0 runs
// add212(s, 1), scale2k and add212(e, -1) on the same s.  Where an exact
// product is an f32, Dekker's y may be -0 and the FMA's is +0 (above); a
// Mul22's u = y + c then differs only where its cross products c sum to -0,
// and its hi t.hi + u only where t.hi is -0.  In exp_poly:
//   - r.hi is never -0: exp_reduce's h1 = xc - kf L1 is +0 at xc = -0
//     (where kf = -0), so s.hi, the TwoSum's hi and r.hi are never -0;
//   - the Horner's w r: w.hi > 0 (W(r) in [0.4, 0.6]), so t.hi is never
//     -0 and only w.lo may differ; add22(w, {W_H[j], W_L[j]}) adds it to
//     W_L[j] != 0 for j > 0 and to W_L[0] = +0: gone;
//   - r r: a square, y is +0 in both forms (al al - err3 is -0 only from
//     -0 - (+0), and al al is never -0): none.  So z's u is never -0, and
//     z.lo = u - (RN(t.hi + u) - t.hi) is never -0 either;
//   - z w: c = z.hi w.lo + z.lo w.hi, whose second term is never -0
//     (z.lo is not, w.hi > 0), so c is never -0 and u = y + c is the same
//     for either zero y: none;
//   - add22(r, q): the same operands.
// So the k == 0 branch needs no test of its own (the sigmoid argument
// above leans on exp22's +1 for z w; this one does not).
// tests/test_torch_math_fma.py emulates this path exactly on the CPU and
// holds it to expm122 on math_variants.exp_log_edges, where zero errors of
// the other sign arise on both branches.
// ---------------------------------------------------------------------------

// expm122 with exp_poly_fma; *ok as exp22_fma's.
__device__ __forceinline__ ff2 expm122_fma(float xh, float xl, bool* ok) {
  int k;
  ff2 r = exp_reduce(xh, xl, &k);
  const float ar = fabsf(r.hi);
  *ok = ar <= 0.5f && (ar >= 0x1p-48f || ar == 0.0f);   // exp22_fma's
  ff2 s = exp_poly_fma(r);
  ff2 p = add212(s, 1.0f);
  ff2 e = scale2k(p.hi, p.lo, k);
  ff2 g = add212(e, -1.0f);
  bool ovf = e.hi == inf32();
  ff2 o = k == 0 ? s : ff2{ovf ? e.hi : g.hi, ovf ? 0.0f : g.lo};
  if (fabsf(xh) < kIdentity) o = {xh, xl};
  bool big = xh > kExpClipHi;
  bool tiny = xh < kExpClipLo;
  if (big || tiny) o = {big ? inf32() : -1.0f, 0.0f};
  if (xh != xh) return {xh, xh};
  return o;
}

// expm122 itself, out of line: it runs only outside the domain.
__device__ __noinline__ ff2 expm122_far(float xh, float xl) {
  return expm122(xh, xl);
}

// expm122(xh, xl), bit for bit.
__device__ __forceinline__ ff2 expm122_fmapath(float xh, float xl) {
  bool ok;
  ff2 r = expm122_fma(xh, xl, &ok);
  if (!ok) r = expm122_far(xh, xl);
  return r;
}

// ---------------------------------------------------------------------------
// exp22 bit for bit on the FMA TwoProd (the ff_math kernel's EXP instance):
// exp22_fma where its test on r passes, exp22 itself elsewhere.  8 TwoProds
// an element.  No proof beyond those above is needed; these lines cover it:
//   - exactness: the products are exp_poly's (the Horner's w.hi r.hi, r.hi
//     r.hi, z.hi w.hi), and the bounds above sigmoid22_fma derive their
//     exactness from r alone (|r.hi| <= 1/2 and (|r.hi| >= 2^-48 or r.hi ==
//     0), a domain symmetric in r): W(r) in [0.4, 0.6] and w.hi in
//     [2^-16, 1] hold for either sign of r.  Their exp_reduce(-|x|) only
//     names sigmoid's argument; no step uses x <= 0 (the bounds on div22
//     and on silu's last product, which do, are not exp's);
//   - signed zeros: on that domain exp_poly_fma(r) is exp_poly(r) bit for
//     bit, zero signs included (the trace above expm122_fma, which also
//     holds for either sign of x), so em1 is exp22's, and so is all that
//     follows it: add212(em1, 1), scale2k and the selections;
//   - scale2k multiplies p by 2^k1 and 2^k2, exact powers of two for every
//     k the clip allows (-152 <= k <= 128, |k1|, |k2| <= 76), and both paths
//     feed it the same p and k;
//   - the clip, overflow and nan selections are exp22's own statements.
// The test sends |x| below 2^-48 (where r is x), r cancelled below 2^-48
// near k ln2 and lo limbs that break |r.hi| <= 1/2 to exp22, out of line.
// As on expm1 it is conservative: no FF input shows it at the output (an
// r below 2^-48 leaves Dekker's partial-product underflow far under lo's
// last bit, beneath the +1; lo limbs beyond hi overflow both forms alike;
// test_exp_guard_is_conservative in tests/test_torch_math_fma.py).

// exp22 itself, out of line: it runs only outside the domain.
__device__ __noinline__ ff2 exp22_far(float xh, float xl) {
  return exp22(xh, xl);
}

// exp22(xh, xl), bit for bit.
__device__ __forceinline__ ff2 exp22_fmapath(float xh, float xl) {
  bool ok;
  ff2 r = exp22_fma(xh, xl, &ok);
  if (!ok) r = exp22_far(xh, xl);
  return r;
}

// sigmoid22 with the twins; *ok as exp22_fma's.
__device__ __forceinline__ ff2 sigmoid22_fma_body(float xh, float xl,
                                                  bool* ok) {
  float ns = xh < 0.0f ? 1.0f : -1.0f;          // -sgn
  ff2 z = exp22_fma(mul(ns, xh), mul(ns, xl), ok);
  ff2 d = add212(z, 1.0f);
  ff2 n = xh >= 0.0f ? ff2{1.0f, 0.0f} : z;
  ff2 r = div22_fma(n, d);
  if (xh != xh) return {xh, xh};
  return r;
}

// The Dekker bodies, out of line: they run only outside the domain.
__device__ __noinline__ ff2 sigmoid22_far(float xh, float xl) {
  return sigmoid22(xh, xl);
}
__device__ __noinline__ ff2 silu22_far(float xh, float xl) {
  return silu22(xh, xl);
}

// sigmoid22(xh, xl), bit for bit.
__device__ __forceinline__ ff2 sigmoid22_fma(float xh, float xl) {
  bool ok;
  ff2 r = sigmoid22_fma_body(xh, xl, &ok);
  if (!ok) r = sigmoid22_far(xh, xl);
  return r;
}

// silu22(xh, xl), bit for bit.
__device__ __forceinline__ ff2 silu22_fma(float xh, float xl) {
  if (xh == 0.0f) return {xh, 0.0f};
  if (xh == -inf32()) return {0.0f, 0.0f};
  if (xh == inf32()) return {inf32(), 0.0f};
  bool ok;
  const ff2 s = sigmoid22_fma_body(xh, xl, &ok);
  const ff2 t = two_prod_fma(xh, s.hi);                 // mul22({xh, xl}, s)
  const float u = add(t.lo, add(mul(xh, s.lo), mul(xl, s.hi)));
  const float at = fabsf(t.hi);
  ff2 r = fast_two_sum(t.hi, u);
  if (!(ok && at >= 0x1p-100f && at < 0x1p+100f && u != 0.0f))
    r = silu22_far(xh, xl);
  return r;
}

// ---------------------------------------------------------------------------
// log1p22 and pow22 bit for bit, on the FMA TwoProd (the ff_math kernel's
// LOG1P and POW instances), in the manner of sigmoid22_fma above: one test
// an element, and log1p22 / pow22 themselves where it fails.
// log1p runs 7 (near branch) or 8 (far) TwoProds an element, pow 17.
//
// Exactness (Dekker's domain as above: both operands below 2^115, and the
// exponents' sum ea + eb >= -103).  The products, for an element whose
// atanh argument s (log_core's (m - 1) / (m + 1), or log1p's near-branch
// x / (2 + x)) has 2^-48 <= |s.hi| <= 1/2:
//   - div22's ch d.hi: s ~ n / d with n = m - 1 and d = m + 1, so
//     |s| <= 1/2 puts m in ~[1/3, 3] and d.hi in ~[4/3, 4] (log1p: d =
//     2 + x, the same), and ch ~ s.hi: |ch d.hi| >= 2^-48;
//   - atanh_poly's s.hi s.hi >= 2^-96; its Horner's a.hi z.hi, where z.hi
//     = RN(s.hi^2) in [2^-96, 1/4] and a.hi >= S_F32[0] ~ 0.111 (exponent
//     -4; S(z) <= atanh(1/2) / (1/2) < 1.1): ea + eb >= -100;
//   - s.hi a.hi, a.hi = S(z) in [1, 1.1]: >= 2^-48;
//   - mul212(ln2, e), e an integer with |e| <= 129: >= 0.69, or 0.
// The bound 2^-48 is sigmoid's: 2^-50 would put z.hi at 2^-100 and the
// Horner's exponents at -104.  Where log_core's n.hi == 0 (m == 1, x an
// exact power of two, frequent in pow), s is (+0, +0) and every product of
// s and z is zero: exact too.  pow's l.hi b.hi is tested: |t.hi| >= 2^-100
// and |b.hi| < kSplitSafe, with |l.hi| <= 129 ln2 + 2 atanh(1/2) < 91
// wherever s passed; exp22's products: exp22_fma's *ok.  So log22_fma's
// test is on s (or n.hi == 0), log1p's near branch tests its s, and pow
// takes log22_fma's and exp22_fma's tests and the one on l b.  Every other
// element runs log1p22 / pow22 itself: log's s below 2^-48
// (m within 2^-47 of 1: x = 2^k (1 + tiny)), lo limbs that put s beyond
// 1/2 (lo beyond hi; 2 + x near 0), |l b| below 2^-100 (tiny b, and
// a == 1), |b| from 2^100, exp's r off its domain, and +-0, +-inf, nan
// (a == 0 or inf gives l = -inf or inf, b == 0 gives t = 0).
//
// Signed zeros (as above: where the exact product is an f32, Dekker's y
// may be -0 and the FMA's is +0, and a Mul22's lo then differs only in
// sign, where its cross products sum to -0).  Where each goes:
//   - div22: x1 = a.hi - t.hi is never -0: gone (as in sigmoid22_fma);
//   - s s: a square, Dekker's y is +0: none;
//   - the Horner's a z: into add22(a, {S_H[j], S_L[j]}), whose a.lo +
//     S_L[j] is S_L[j] for j > 0 and +0 for S_L[0] == +0: gone;
//   - mul212(ln2, e) = (t.hi, u - (RN(t.hi + u) - t.hi)), u = y + LN2_L e:
//     Dekker's split of LN2_H has a positive low half, so at e == 0 its y
//     is +0 as the FMA's; at other exact products (e a power of two) y
//     meets LN2_L e != 0: gone.  Its lo is -0 only where u is, which needs
//     LN2_L e == -0 (e == 0) and y == -0: never;
//   - log_core's s a: its lo, doubled, into add22(tl, l) as v = err +
//     (tl.lo + l.lo), where tl.lo, never -0, turns a zero l.lo into +0 or
//     tl.lo: gone;
//   - log1p's near-branch s a: its lo, doubled, is the output's lo: u == 0
//     sends the element to log1p22 (one test);
//   - pow's l b (t.hi != 0 by its test): t.lo enters exp_reduce's v = t.lo
//     - k L3: k L3 != 0 for k != 0, and t.lo - (-0) = +0 for k == +0; for
//     k == -0 (t.hi in (-ln2/2, 0)), v = t.lo and add212((t.hi, +0), v)
//     is the TwoSum of t.hi != 0 and a zero, whose err is +0: gone;
//   - exp22's own: as in sigmoid22_fma (its +1).
// tests/test_torch_math_fma_log.py emulates this path exactly on the CPU
// and holds it to log1p22 and pow22 on math_variants.log_pow_edges.
// ---------------------------------------------------------------------------

// Mul212 on two_prod_fma.
__device__ __forceinline__ ff2 mul212_fma(ff2 a, float b) {
  ff2 t = two_prod_fma(a.hi, b);
  float u = add(t.lo, mul(a.lo, b));
  return fast_two_sum(t.hi, u);
}

// atanh_poly on mul22_fma (the same constants and op order).
__device__ __forceinline__ ff2 atanh_poly_fma(ff2 s) {
  const float S_F32[6] = {0x1.c71c72p-4f, 0x1.745d18p-4f, 0x1.3b13b2p-4f,
                          0x1.111112p-4f, 0x1.e1e1e2p-5f, 0x1.af286cp-5f};
  const float S_H[4] = {0x1p+0f, 0x1.555556p-2f, 0x1.99999ap-3f,
                        0x1.24924ap-3f};
  const float S_L[4] = {0.0f, -0x1.555556p-27f, -0x1.99999ap-29f,
                        -0x1.b6db6ep-28f};
  ff2 z = mul22_fma(s, s);
  float t = S_F32[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) t = add(mul(t, z.hi), S_F32[i]);
  ff2 a = {t, 0.0f};
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    a = mul22_fma(a, z);
    a = add22(a, {S_H[j], S_L[j]});
  }
  return a;
}

// The atanh argument's domain above.
__device__ __forceinline__ bool atanh_arg_ok(float sh) {
  const float as = fabsf(sh);
  return as <= 0.5f && as >= 0x1p-48f;
}

// log22's reduction x = 2^e m, m in [1/sqrt2, sqrt2) by exponent-bit
// surgery, as log_core's n = m - 1 and d = m + 1; returns e.
__device__ __forceinline__ float log_reduce(float xh, float xl, ff2* n,
                                            ff2* d) {
  int bits = __float_as_int(xh);
  int e = ((bits >> 23) & 0xFF) - 127;
  float mh = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  bool big = mh > 0x1.6a09e6p+0f;
  mh = big ? mul(mh, 0.5f) : mh;
  e += big ? 1 : 0;
  const ff2 m = {mh, scale2k(xl, 0.0f, -e).hi};
  *n = add212(m, -1.0f);
  *d = add212(m, 1.0f);
  return static_cast<float>(e);
}

// 2 s S(s^2) with s = n / d, on the twins: the atanh kernel of log_core
// and of log1p's near branch (div22, atanh_poly, mul22, the doubling).
// *sh: s.hi; *u: the last Mul22's u, the source of its low limb.
__device__ __forceinline__ ff2 atanh2_fma(ff2 n, ff2 d, float* sh,
                                          float* u) {
  const ff2 s = div22_fma(n, d);
  const ff2 a = atanh_poly_fma(s);
  const ff2 t = two_prod_fma(s.hi, a.hi);               // mul22(s, a)
  *u = add(t.lo, add(mul(s.hi, a.lo), mul(s.lo, a.hi)));
  *sh = s.hi;
  const ff2 l = fast_two_sum(t.hi, *u);
  return {mul(2.0f, l.hi), mul(2.0f, l.lo)};            // exact
}

// log_core's e ln2 + l, and log22's values at x = 0, x < 0, inf and nan.
__device__ __forceinline__ ff2 log_finish(float xh, float ef, ff2 l) {
  const float LN2_H = 0x1.62e43p-1f;   // ln2 as an FF constant
  const float LN2_L = -0x1.05c61p-29f;
  ff2 r = add22(mul212_fma({LN2_H, LN2_L}, ef), l);
  bool bad = (xh < 0.0f) || (xh != xh);
  float rh = xh == 0.0f ? -inf32() : (bad ? __int_as_float(0x7fc00000) : r.hi);
  rh = xh == inf32() ? inf32() : rh;
  float rl = (xh == 0.0f || bad || xh == inf32()) ? 0.0f : r.lo;
  return {rh, rl};
}

// log22 on the twins; *ok: its s is in the domain, or n.hi == 0.
__device__ __forceinline__ ff2 log22_fma(float xh, float xl, bool* ok) {
  ff2 n, d;
  const float ef = log_reduce(xh, xl, &n, &d);
  float sh, u;
  const ff2 l = atanh2_fma(n, d, &sh, &u);
  *ok = atanh_arg_ok(sh) || n.hi == 0.0f;
  return log_finish(xh, ef, l);
}

// log1p22 on the twins; *ok: the element is in the domain above (the
// branches that run no product pass).  Both branches share one atanh
// kernel: its s is x / (2 + x) on the near branch, log22's of the exact
// 1 + x beyond, so a warp of mixed branches runs it once.
__device__ __forceinline__ ff2 log1p22_fma_body(float xh, float xl,
                                                bool* ok) {
  *ok = true;
  if (xh != xh) return {xh, xh};
  if (xh == inf32()) return {inf32(), 0.0f};
  if (fabsf(xh) < kIdentity) return {xh, xl};
  const bool near = xh >= -0x1.2bec32p-2f && xh <= 0x1.a82798p-2f;
  ff2 n = {xh, xl}, d, f = {0.0f, 0.0f};
  float ef = 0.0f;
  if (near) {
    d = add212(n, 2.0f);
  } else {
    const ff2 w = two_sum(xh, 1.0f);
    f = fast_two_sum(w.hi, add(w.lo, xl));
    ef = log_reduce(f.hi, f.lo, &n, &d);
  }
  float sh, u;
  const ff2 l = atanh2_fma(n, d, &sh, &u);
  if (near) {
    *ok = atanh_arg_ok(sh) && u != 0.0f;
    return l;
  }
  *ok = atanh_arg_ok(sh) || n.hi == 0.0f;
  return log_finish(f.hi, ef, l);
}

// pow22 itself, out of line: it runs only outside the domain.
__device__ __noinline__ ff2 pow22_far(float ah, float al, float bh,
                                      float bl) {
  return pow22(ah, al, bh, bl);
}

// log1p22(xh, xl), bit for bit.  log1p22 itself runs inline where the
// test fails: called out of line, it would hold the kernel at 37 registers
// and 6 blocks of 256 an SM (28 and 8 inline; math_variants "log1p far
// body out of line" times it).
__device__ __forceinline__ ff2 log1p22_fma(float xh, float xl) {
  bool ok;
  ff2 r = log1p22_fma_body(xh, xl, &ok);
  if (!ok) r = log1p22(xh, xl);
  return r;
}

// log22(xh, xl), bit for bit (the ff_math kernel's LOG instance; 8
// TwoProds an element): log22_fma where its test passes, log22 itself
// elsewhere, inline (as log1p22 above).  The test and its proof are
// log22_fma's; log's own output has no exp after it, so the trace above
// must end in log_finish.  l.hi = 2 RN(s.hi a.hi) is the same in both forms
// (s.hi is never -0: +0 where n.hi == 0, else |s.hi| >= 2^-48; a.hi > 0),
// and a zero l.lo of either sign meets tl.lo in add22(tl, l)'s v = err +
// (tl.lo + l.lo).  tl.lo is never -0, also at e == 0: there tl =
// mul212_fma(ln2, +0) has t = (+0, +0) and u = +0 + LN2_L (+0) = +0 +
// (-0) = +0, so tl = (+0, +0) (Dekker's the same), and +0 + (-0) = +0:
// gone.  So log needs no test beyond log22_fma's.
__device__ __forceinline__ ff2 log22_fmapath(float xh, float xl) {
  bool ok;
  ff2 r = log22_fma(xh, xl, &ok);
  if (!ok) r = log22(xh, xl);
  return r;
}

// pow22(ah, al, bh, bl), bit for bit.
__device__ __forceinline__ ff2 pow22_fma(float ah, float al, float bh,
                                         float bl) {
  bool lok, eok;
  const ff2 l = log22_fma(ah, al, &lok);
  const ff2 t = mul22_fma(l, {bh, bl});
  ff2 r = exp22_fma(t.hi, t.lo, &eok);
  if (ah == 0.0f || ah == inf32()) {
    const bool zero = ah == 0.0f;
    if (bh > 0.0f) r.hi = zero ? 0.0f : inf32();
    if (bh < 0.0f) r.hi = zero ? inf32() : 0.0f;
    r.lo = 0.0f;
  }
  if (bh == 0.0f) r = {1.0f, 0.0f};
  if (!(lok && eok && fabsf(t.hi) >= 0x1p-100f && fabsf(bh) < kSplitSafe))
    r = pow22_far(ah, al, bh, bl);
  return r;
}

}  // namespace ffk
