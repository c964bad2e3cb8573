// BN254-Fr arithmetic on eight 32-bit limbs in Montgomery form (R = 2^256),
// shared by K1 fr_mul, K11 mul_add_words, K12 fr_inv and K13 logup_sum.
// Every limb product is a mad.lo/mad.hi pair on a PTX carry chain, so a
// field product is about 330 integer instructions where fr_arith.cuh's
// 16-bit Barrett product takes about 1800.
//
// The product (mont_mul) is a separated operand scan: the 16-word product
// a * b, then a word-by-word Montgomery reduction of its low half.  Rows of
// the product run two carry chains that share no register, the low words
// of the limb products into x and the high words into y, so the compiler
// can interleave them; x + y is the product.  The squaring (mont_sqr) forms
// the 28 cross products once, doubles them and adds the 8 squares: 36 limb
// products where the product takes 64.  The reduction (mont_reduce) of t =
// t_hi * 2^256 + t_lo returns REDC(t_lo) + t_hi, then p subtracted once:
//
//   REDC(t_lo) = (t_lo + M * p) / 2^256 <= p, for M = t_lo * (-p^-1) mod 2^256
//   taken one 32-bit word of M at a time;
//   t_hi < p whenever t < p * 2^256, so the sum is below 2p.
//
// So mont_mul(a, b) = a * b * 2^-256 mod p, canonical, for a < p and any b
// < 2^256 (the canonical inputs of the kernels, a multiplicity, R^2 mod p).
// A value enters Montgomery form by a product with R^2 mod p (mont_to) and
// leaves it by a reduction with t_hi = 0 (mont_from).  A product of an
// element in Montgomery form with a plain one is plain.
//
// Each carry chain drops its last carry only where the bound above makes it
// zero; tests/test_torch_fr_mont.py walks this code's chains on Python ints
// in the same order and checks every dropped carry, and reads the constants
// below from this file.
#pragma once

#include "limb_common.cuh"

#define MONT_LIMBS 8

// p, R^2 mod p and R mod p (one in Montgomery form) as little-endian 32-bit
// words, and -p^-1 mod 2^32
__constant__ uint32_t c_mont_p[MONT_LIMBS] = {
    0xf0000001, 0x43e1f593, 0x79b97091, 0x2833e848,
    0x8181585d, 0xb85045b6, 0xe131a029, 0x30644e72};
__constant__ uint32_t c_mont_r2[MONT_LIMBS] = {
    0xae216da7, 0x1bb8e645, 0xe35c59e3, 0x53fe3ab1,
    0x53bb8085, 0x8c49833d, 0x7f4e44a5, 0x0216d0b1};
__constant__ uint32_t c_mont_one[MONT_LIMBS] = {
    0x4ffffffb, 0xac96341c, 0x9f60cd29, 0x36fc7695,
    0x7879462e, 0x666ea36f, 0x9a07df2f, 0x0e0a77c1};
__constant__ uint32_t c_mont_pinv = 0xefffffff;

// one PTX instruction each; the carry flag passes from one to the next in
// program order (volatile keeps that order)
namespace ptx {

#define FR_MONT_PTX3(fn, op)                                                    \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t d;                                                                 \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));     \
    return d;                                                                   \
  }
#define FR_MONT_PTX2(fn, op)                                        \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {  \
    uint32_t d;                                                     \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));     \
    return d;                                                       \
  }

FR_MONT_PTX3(mad_lo_cc, "mad.lo.cc.u32")
FR_MONT_PTX3(madc_lo_cc, "madc.lo.cc.u32")
FR_MONT_PTX3(mad_hi_cc, "mad.hi.cc.u32")
FR_MONT_PTX3(madc_hi_cc, "madc.hi.cc.u32")
FR_MONT_PTX3(madc_hi, "madc.hi.u32")
FR_MONT_PTX2(add_cc, "add.cc.u32")
FR_MONT_PTX2(addc_cc, "addc.cc.u32")
FR_MONT_PTX2(addc, "addc.u32")
FR_MONT_PTX2(sub_cc, "sub.cc.u32")
FR_MONT_PTX2(subc_cc, "subc.cc.u32")
FR_MONT_PTX2(subc, "subc.u32")

#undef FR_MONT_PTX3
#undef FR_MONT_PTX2

}  // namespace ptx

// t = x + y over 16 words (y[0] is 0; the sum is below 2^512)
__device__ __forceinline__ void mont_merge(const uint32_t x[16], const uint32_t y[16],
                                           uint32_t t[16]) {
  t[0] = x[0];
  t[1] = ptx::add_cc(x[1], y[1]);
#pragma unroll
  for (int k = 2; k < 15; ++k) t[k] = ptx::addc_cc(x[k], y[k]);
  t[15] = ptx::addc(x[15], y[15]);
}

// t = a * b as 16 words
__device__ __forceinline__ void mont_wide_mul(const uint32_t a[8], const uint32_t b[8],
                                              uint32_t t[16]) {
  uint32_t x[16], y[16];
  // row 0: the limb products alone
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = a[j] * b[0];
    y[j + 1] = __umulhi(a[j], b[0]);
  }
  y[0] = 0;
#pragma unroll
  for (int k = 8; k < 16; ++k) x[k] = 0;
#pragma unroll
  for (int k = 9; k < 16; ++k) y[k] = 0;
  // row i: low words into x[i .. i+7], the carry into x[i+8] (still 0);
  // high words into y[i+1 .. i+8], the carry into y[i+9] (still 0), none
  // past the top row's y[15]
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    x[i] = ptx::mad_lo_cc(a[0], b[i], x[i]);
#pragma unroll
    for (int j = 1; j < 8; ++j) x[i + j] = ptx::madc_lo_cc(a[j], b[i], x[i + j]);
    x[i + 8] = ptx::addc(0u, 0u);
    y[i + 1] = ptx::mad_hi_cc(a[0], b[i], y[i + 1]);
    if (i < 7) {
#pragma unroll
      for (int j = 1; j < 8; ++j) y[i + j + 1] = ptx::madc_hi_cc(a[j], b[i], y[i + j + 1]);
      y[i + 9] = ptx::addc(0u, 0u);
    } else {
#pragma unroll
      for (int j = 1; j < 7; ++j) y[i + j + 1] = ptx::madc_hi_cc(a[j], b[i], y[i + j + 1]);
      y[15] = ptx::madc_hi(a[7], b[i], y[15]);
    }
  }
  mont_merge(x, y, t);
}

// t = a * a as 16 words: the cross products a[i] * a[j], i < j, once (row
// i: low words into x[2i+1 .. i+7], carry into x[i+8]; high words into
// y[2i+2 .. i+8], carry into y[i+9]), then doubled, then the squares
// a[i]^2 added in one chain
__device__ __forceinline__ void mont_wide_sqr(const uint32_t a[8], uint32_t t[16]) {
  uint32_t x[16], y[16], c[16];
  x[0] = 0;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    x[j] = a[j] * a[0];
    y[j + 1] = __umulhi(a[j], a[0]);
  }
  y[0] = y[1] = 0;
#pragma unroll
  for (int k = 8; k < 16; ++k) x[k] = 0;
#pragma unroll
  for (int k = 9; k < 16; ++k) y[k] = 0;
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    x[2 * i + 1] = ptx::mad_lo_cc(a[i + 1], a[i], x[2 * i + 1]);
#pragma unroll
    for (int j = i + 2; j < 8; ++j) x[i + j] = ptx::madc_lo_cc(a[j], a[i], x[i + j]);
    x[i + 8] = ptx::addc(0u, 0u);
    y[2 * i + 2] = ptx::mad_hi_cc(a[i + 1], a[i], y[2 * i + 2]);
#pragma unroll
    for (int j = i + 2; j < 8; ++j) y[i + j + 1] = ptx::madc_hi_cc(a[j], a[i], y[i + j + 1]);
    y[i + 9] = ptx::addc(0u, 0u);
  }
  mont_merge(x, y, c);
  // t = 2c (c < 2^511) plus the squares (the sum is a^2 < 2^512)
  t[0] = c[0] << 1;
#pragma unroll
  for (int k = 1; k < 16; ++k) t[k] = __funnelshift_l(c[k - 1], c[k], 1);
  t[0] = ptx::mad_lo_cc(a[0], a[0], t[0]);
  t[1] = ptx::madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i] = ptx::madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = ptx::madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  t[14] = ptx::madc_lo_cc(a[7], a[7], t[14]);
  t[15] = ptx::madc_hi(a[7], a[7], t[15]);
}

// out = r - p if that does not borrow, else r (r < 2p)
__device__ __forceinline__ void mont_reduce_once(const uint32_t r[8], uint32_t out[8]) {
  uint32_t d[8];
  d[0] = ptx::sub_cc(r[0], c_mont_p[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d[k] = ptx::subc_cc(r[k], c_mont_p[k]);
  const uint32_t borrow = ptx::subc(0u, 0u);
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = borrow ? r[k] : d[k];
}

// out = t * 2^-256 mod p, canonical, for t < p * 2^256: REDC of the low
// half (u, nine words while p's multiple is added), plus the high half
__device__ __forceinline__ void mont_reduce(const uint32_t t[16], uint32_t out[8]) {
  uint32_t u[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) u[k] = t[k];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t m = u[0] * c_mont_pinv;
    // low words: u[0] becomes 0 and only its carry goes on; the carry out
    // of u[7] into u[8] (still 0)
    u[0] = ptx::mad_lo_cc(m, c_mont_p[0], u[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) u[j] = ptx::madc_lo_cc(m, c_mont_p[j], u[j]);
    u[8] = ptx::addc(0u, 0u);
    // high words into u[1 .. 8]; u + m * p < 2^288, so nothing carries out
    u[1] = ptx::mad_hi_cc(m, c_mont_p[0], u[1]);
#pragma unroll
    for (int j = 1; j < 7; ++j) u[j + 1] = ptx::madc_hi_cc(m, c_mont_p[j], u[j + 1]);
    u[8] = ptx::madc_hi(m, c_mont_p[7], u[8]);
    // divide by 2^32
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = u[k + 1];
  }
  uint32_t r[8];
  r[0] = ptx::add_cc(u[0], t[8]);
#pragma unroll
  for (int k = 1; k < 7; ++k) r[k] = ptx::addc_cc(u[k], t[8 + k]);
  r[7] = ptx::addc(u[7], t[15]);
  mont_reduce_once(r, out);
}

// out = a * b * 2^-256 mod p (a < p, b < 2^256); out may alias a or b
__device__ __forceinline__ void mont_mul(const uint32_t a[8], const uint32_t b[8],
                                         uint32_t out[8]) {
  uint32_t t[16];
  mont_wide_mul(a, b, t);
  mont_reduce(t, out);
}

// out = a^2 * 2^-256 mod p (a < p); out may alias a
__device__ __forceinline__ void mont_sqr(const uint32_t a[8], uint32_t out[8]) {
  uint32_t t[16];
  mont_wide_sqr(a, t);
  mont_reduce(t, out);
}

// out = a * R mod p for a < 2^256 (a product with R^2 mod p)
__device__ __forceinline__ void mont_to(const uint32_t a[8], uint32_t out[8]) {
  uint32_t r2[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r2[k] = c_mont_r2[k];
  mont_mul(r2, a, out);
}

// out = a * R^-1 mod p, canonical (a reduction with a zero high half)
__device__ __forceinline__ void mont_from(const uint32_t a[8], uint32_t out[8]) {
  uint32_t t[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t[k] = a[k];
    t[k + 8] = 0;
  }
  mont_reduce(t, out);
}

// out = (a + b) mod p for a, b < p (in either form)
__device__ __forceinline__ void mont_add(const uint32_t a[8], const uint32_t b[8],
                                         uint32_t out[8]) {
  uint32_t s[8];
  s[0] = ptx::add_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < 7; ++k) s[k] = ptx::addc_cc(a[k], b[k]);
  s[7] = ptx::addc(a[7], b[7]);
  mont_reduce_once(s, out);
}

// out = (a - b) mod p for a, b < p (in either form): p added back under a
// borrow
__device__ __forceinline__ void mont_sub(const uint32_t a[8], const uint32_t b[8],
                                         uint32_t out[8]) {
  uint32_t d[8];
  d[0] = ptx::sub_cc(a[0], b[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d[k] = ptx::subc_cc(a[k], b[k]);
  const uint32_t mask = ptx::subc(0u, 0u);
  out[0] = ptx::add_cc(d[0], c_mont_p[0] & mask);
#pragma unroll
  for (int k = 1; k < 7; ++k) out[k] = ptx::addc_cc(d[k], c_mont_p[k] & mask);
  out[7] = ptx::addc(d[7], c_mont_p[7] & mask);
}

// eight 32-bit words from a row of n <= 16 limbs of 16 bits (int64), zero
// past the row
__device__ __forceinline__ void mont_pack16(const int64_t* row, int n, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = limb_at(row, 2 * k, n) | (limb_at(row, 2 * k + 1, n) << 16);
}

// the 16 canonical int64 limbs of eight words
__device__ __forceinline__ void mont_unpack16(const uint32_t w[8], int64_t* row) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    row[2 * k] = (int64_t)(w[k] & LIMB_MASK);
    row[2 * k + 1] = (int64_t)(w[k] >> LIMB_BITS);
  }
}
