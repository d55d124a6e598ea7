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
// exp22: FF exp of an FF argument (repro/core/ffmath.py exp22, same
// constants, same op order).  Constants are the f32 values of the
// reference's, written as hex floats so that no decimal rounding differs.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ ff2 exp22(float xh, float xl) {
  const float INV_LN2 = 0x1.715476p+0f;
  const float L1 = 0x1.62e4p-1f;     // 45426 * 2^-16
  const float L2 = 0x1.7f7ep-20f;    // 49087 * 2^-35
  const float L3 = -0x1.c610cap-37f;
  const float CLIP_LO = -105.0f, CLIP_HI = 89.0f;
  // f32 Horner tail of W, degrees 6..11 (W_F32[0..5])
  const float W_F32[6] = {0x1.a01a02p-16f, 0x1.71de3ap-19f, 0x1.27e4fcp-22f,
                          0x1.ae6456p-26f, 0x1.1eed8ep-29f, 0x1.612462p-33f};
  // FF coefficients of W, degrees 0..5
  const float W_H[6] = {0x1p-1f, 0x1.555556p-3f, 0x1.555556p-5f,
                        0x1.111112p-7f, 0x1.6c16c2p-10f, 0x1.a01a02p-13f};
  const float W_L[6] = {0.0f, -0x1.555556p-28f, -0x1.555556p-30f,
                        -0x1.dddddep-32f, -0x1.27d27ep-35f,
                        -0x1.7f97fap-39f};

  // Cody–Waite reduction x = k*ln2 + r (jnp.clip / jnp.round)
  float xc = fminf(fmaxf(xh, CLIP_LO), CLIP_HI);
  float kf = rintf(mul(xc, INV_LN2));           // round half to even
  float h1 = sub(xc, mul(kf, L1));              // exact
  ff2 s = two_sum(h1, -mul(kf, L2));
  float v = sub(xl, mul(kf, L3));
  ff2 r = add212(s, v);
  int k = static_cast<int>(kf);

  // expm1(r) = r + r^2 W(r)
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
  ff2 em1 = add22(r, q);

  ff2 p = add212(em1, 1.0f);
  ff2 e = scale2k(p.hi, p.lo, k);
  bool big = xh > CLIP_HI;
  bool tiny = xh < CLIP_LO;
  float eh = big ? __int_as_float(0x7f800000) : (tiny ? 0.0f : e.hi);
  float el = (big || tiny || eh == __int_as_float(0x7f800000)) ? 0.0f : e.lo;
  if (xh != xh) return {xh, xh};
  return {eh, el};
}

}  // namespace ffk
