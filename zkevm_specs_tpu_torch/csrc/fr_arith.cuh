// BN254-Fr arithmetic on 16-bit limbs held in registers, used by K8
// horner_rlc alone (K1, K11 and K12 moved to fr_mont.cuh's 32-bit
// Montgomery product): the 16 x 16-limb schoolbook product (with an
// addend folded into its first column) and the Barrett reduction of
// zkevm_specs_tpu/ops/fr.py:reduce_wide (fr.py:43-63), step by step:
// q1 = x >> 240, q3 = (q1 * mu) >> 272, r = (x - q3 * p) mod 2^272, then p
// subtracted at most twice.  Columns accumulate in 64-bit registers, so no
// carry pass is needed between products; every loop is unrolled at compile
// time and the constants p and mu sit in constant memory, read with
// uniform indices.
#pragma once

#include "limb_common.cuh"

// x = a * b + addend as 32 canonical limbs (a column holds at most 16
// products < 2^32 plus a carry, so a 64-bit accumulator never overflows;
// addend < 2^32)
__device__ __forceinline__ void fr_product(const uint32_t a[16], const uint32_t b[16],
                                           uint32_t addend, uint32_t x[32]) {
  uint64_t acc = addend;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = k - i;
      if (j >= 0 && j < 16) acc += (uint64_t)a[i] * b[j];
    }
    x[k] = (uint32_t)acc & LIMB_MASK;
    acc >>= LIMB_BITS;
  }
}

// out = x mod p for x < 2^512 (Barrett, b = 2^16, k = 16; HAC 14.42)
__device__ __forceinline__ void fr_barrett(const uint32_t x[32], uint32_t out[16]) {
  // q3 = ((x >> 240) * mu) >> 272: columns 17..33 of the 34-limb product
  uint32_t q3[17];
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 34; ++k) {
#pragma unroll
    for (int i = 0; i < 17; ++i) {
      const int j = k - i;
      if (j >= 0 && j < 17) acc += (uint64_t)x[15 + i] * c_mu17[j];
    }
    if (k >= 17) q3[k - 17] = (uint32_t)acc & LIMB_MASK;
    acc >>= LIMB_BITS;
  }

  // r = (x mod 2^272) - (q3 * p mod 2^272), mod 2^272
  uint32_t r[17];
  acc = 0;
  int borrow = 0;
#pragma unroll
  for (int k = 0; k < 17; ++k) {
#pragma unroll
    for (int i = 0; i <= k; ++i) acc += (uint64_t)q3[i] * c_p17[k - i];
    const int v = (int)x[k] - (int)((uint32_t)acc & LIMB_MASK) - borrow;
    r[k] = (uint32_t)v & LIMB_MASK;
    borrow = v < 0;
    acc >>= LIMB_BITS;
  }

  // subtract p at most twice (r < 3p)
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    uint32_t d[17];
    borrow = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const int v = (int)r[k] - (int)c_p17[k] - borrow;
      d[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
    if (!borrow) {
#pragma unroll
      for (int k = 0; k < 17; ++k) r[k] = d[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = r[k];
}

// out = (a * b) mod p for canonical a, b; out may alias a or b (the
// product is formed in its own registers first)
__device__ __forceinline__ void fr_mul16(const uint32_t a[16], const uint32_t b[16],
                                         uint32_t out[16]) {
  uint32_t x[32];
  fr_product(a, b, 0u, x);
  fr_barrett(x, out);
}

// out = (a - b) mod p for canonical a, b: the 16-limb borrow chain, then p
// added back mod 2^256 under a borrow (zkevm_specs_tpu/ops/fr.py:sub)
__device__ __forceinline__ void fr_sub16(const uint32_t a[16], const uint32_t b[16],
                                         uint32_t out[16]) {
  uint32_t d[16];
  int borrow = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = (int)a[k] - (int)b[k] - borrow;
    d[k] = (uint32_t)v & LIMB_MASK;
    borrow = v < 0;
  }
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t s = d[k] + (borrow ? c_p17[k] : 0u) + carry;
    out[k] = s & LIMB_MASK;
    carry = s >> LIMB_BITS;
  }
}

// out = (a + b) mod p for canonical a, b (a + b < 2p < 2^255 fits 16 limbs;
// p subtracted unless that borrows: zkevm_specs_tpu/ops/fr.py:add)
__device__ __forceinline__ void fr_add16(const uint32_t a[16], const uint32_t b[16],
                                         uint32_t out[16]) {
  uint32_t s[16], d[16];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t v = a[k] + b[k] + carry;
    s[k] = v & LIMB_MASK;
    carry = v >> LIMB_BITS;
  }
  int borrow = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = (int)s[k] - (int)c_p17[k] - borrow;
    d[k] = (uint32_t)v & LIMB_MASK;
    borrow = v < 0;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = borrow ? s[k] : d[k];
}
