// K11 mul_add_words: the 512-bit word product a * b + c of 256-bit words and
// the carry constraints of the EVM circuit's arithmetic gadgets, one lane
// per thread, every operand of a lane in registers.
//
// Replaces the XLA computation of zkevm_specs_tpu/evm/instruction.py:
// _mul_512_terms (:812), mul_add_words (:827) and mul_add_words_512 (:845),
// and circuits/exp.py:_mul_add_words (:19), which the JAX package runs as a
// chain of some forty field operations.  Each word is lo/hi (two [B|1, w]
// 16-bit-limb rows, w <= 16, canonical below p); a, b, c, d (and e) are the
// ten rows of `Operands`, a [1, w] constant row given stride 0.
//
//   a64, b64  the 64-bit quarters (lo mod 2^64, (lo >> 64) mod 2^64, the
//             same of hi), as Word.to_64s gives them (limbs above 8 drop);
//   t0..t6    t_k = sum_{i+j=k} a64_i * b64_j, exact (< 2^131);
//   L0, L1, L2  t0 + t1 * 2^64, t2 + t3 * 2^64, t4 + t5 * 2^64, exact.
//
// Variant 256 (a * b + c == d mod 2^256), checks in the chain's order:
//   lhs_lo = L0 + c_lo, carry_lo = (lhs_lo - d_lo) * 2^-128,
//   lhs_hi = L1 + c_hi + carry_lo, carry_hi = (lhs_hi - d_hi) * 2^-128,
//   [carry_lo < 2^72, carry_hi < 2^72, lhs_lo == d_lo + carry_lo * 2^128,
//    lhs_hi == d_hi + carry_hi * 2^128], overflow = carry_hi + t4 + t5 + t6;
// variant 512 (a * b + c == d * 2^256 + e): carry_0, carry_1 as above on
//   e, carry_2 = (L2 + carry_1 - d_lo) * 2^-128, [three carries < 2^72,
//   lhs0 == e_lo + carry_0 * 2^128, lhs1 == e_hi + carry_1 * 2^128,
//   L2 + carry_1 == d_lo + carry_2 * 2^128, t6 + carry_2 == d_hi].
// Every sum, difference and product above is taken mod p on canonical
// values, which is what the F chain computes: its narrow steps stay below
// 2^253 < p, and its wide steps are fr.add/sub/mul (K3's Fr modes, K1's
// Barrett reduction, shared here through fr_arith.cuh).  A negative
// difference wraps mod p, so its carry is a 254-bit field value that fails
// the 72-bit check, as in the chain.
//
// In the field the equalities hold for every canonical input (carry * 2^128
// is lhs - rhs); the kernel still computes them as the chain does, with the
// product by 2^128 as a limb shift and one Barrett reduction.
//
// What bounds it on the card: integer multiply-adds.  A lane reads at most
// 10 x 16 limbs (1280 bytes) and writes 4 or 7 verdict bytes and 128 bytes
// of overflow, and does 256 partial products plus two (variant 256) or three
// (variant 512) 16 x 16-limb field products by 2^-128 with their Barrett
// reductions, and a Barrett reduction per equality: far above the card's
// int32 rate-to-bandwidth ratio.  The design keeps every intermediate in
// registers and touches device memory only for the operands and the
// verdicts.
#include "fr_arith.cuh"

namespace {

constexpr int N_OPERANDS = 10;  // a.lo a.hi b.lo b.hi c.lo c.hi d.lo d.hi e.lo e.hi

struct Operands {
  const int64_t* ptr[N_OPERANDS];
  long long stride[N_OPERANDS];  // elements between lanes; 0 for a [1, w] row
  int width[N_OPERANDS];
};

// 2^-128 mod p, 16 limbs
__constant__ uint32_t c_inv128[16] = {
    0xdc6f, 0x76f9, 0x753c, 0x18ee, 0xe70f, 0xa329, 0x7e14, 0x54ad,
    0x84df, 0x4f76, 0x366f, 0x2b16, 0x3579, 0x1fdf, 0x00d7, 0x1331};

__device__ __forceinline__ void load_row(const Operands& o, int k, long long lane, int n,
                                         uint32_t* v) {
  const int64_t* row = o.ptr[k] + lane * o.stride[k];
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = limb_at(row, i, o.width[k]);
}

// (x + y) mod p for canonical x, y: the 17-limb sum, p subtracted unless
// that borrows (K3's FR_ADD)
__device__ __forceinline__ void fr_add16(const uint32_t x[16], const uint32_t y[16],
                                         uint32_t out[16]) {
  uint32_t s[17];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t v = x[k] + y[k] + carry;
    s[k] = v & LIMB_MASK;
    carry = v >> LIMB_BITS;
  }
  s[16] = carry;
  uint32_t d[17];
  int borrow = 0;
#pragma unroll
  for (int k = 0; k < 17; ++k) {
    const int v = (int)s[k] - (int)c_p17[k] - borrow;
    d[k] = (uint32_t)v & LIMB_MASK;
    borrow = v < 0;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = borrow ? s[k] : d[k];
}

// (x - y) mod p for canonical x, y: the 16-limb difference, p added back
// under borrow (K3's FR_SUB)
__device__ __forceinline__ void fr_sub16(const uint32_t x[16], const uint32_t y[16],
                                         uint32_t out[16]) {
  int borrow = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int v = (int)x[k] - (int)y[k] - borrow;
    out[k] = (uint32_t)v & LIMB_MASK;
    borrow = v < 0;
  }
  if (borrow) {
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t v = out[k] + c_p17[k] + carry;
      out[k] = v & LIMB_MASK;
      carry = v >> LIMB_BITS;
    }
  }
}

// (x * c) mod p for a canonical x and a constant c (K1's arithmetic)
__device__ __forceinline__ void fr_mul_const(const uint32_t x[16], const uint32_t* c,
                                             uint32_t out[16]) {
  uint32_t cv[16], w[32];
#pragma unroll
  for (int k = 0; k < 16; ++k) cv[k] = c[k];
  fr_product(x, cv, 0u, w);
  fr_barrett(w, out);
}

__device__ __forceinline__ bool below_2_72(const uint32_t v[16]) {
  bool ok = v[4] < 256u;
#pragma unroll
  for (int k = 5; k < 16; ++k) ok = ok && v[k] == 0u;
  return ok;
}

__device__ __forceinline__ bool equal16(const uint32_t x[16], const uint32_t y[16]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) ok = ok && x[k] == y[k];
  return ok;
}

// carry ripple of non-negative 64-bit columns into 16 canonical limbs
__device__ __forceinline__ void ripple(const uint64_t cols[16], uint32_t out[16]) {
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    acc += cols[k];
    out[k] = (uint32_t)acc & LIMB_MASK;
    acc >>= LIMB_BITS;
  }
}

// the carry of one 128-bit half: carry = (lhs - rhs) * 2^-128, and the
// equality lhs == rhs + carry * 2^128 (both mod p); carry * 2^128 is the
// carry's limbs moved up by eight, then reduced
__device__ __forceinline__ void half_carry(const uint32_t lhs[16], const uint32_t rhs[16],
                                           uint32_t carry[16], bool* eq) {
  uint32_t diff[16], wide[32], shifted[16], back[16];
  fr_sub16(lhs, rhs, diff);
  fr_mul_const(diff, c_inv128, carry);
#pragma unroll
  for (int k = 0; k < 32; ++k) wide[k] = (k >= 8 && k < 24) ? carry[k - 8] : 0u;
  fr_barrett(wide, shifted);
  fr_add16(rhs, shifted, back);
  *eq = equal16(lhs, back);
}

template <bool WIDE>
__global__ void __launch_bounds__(THREADS_PER_BLOCK)
mul_add_words_kernel(Operands o, uint8_t* __restrict__ ok, int64_t* __restrict__ overflow,
                     long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;

  // the quarters: limbs 0..7 of lo, then limbs 0..7 of hi
  uint32_t A[16], B[16];
  load_row(o, 0, lane, 8, A);
  load_row(o, 1, lane, 8, A + 8);
  load_row(o, 2, lane, 8, B);
  load_row(o, 3, lane, 8, B + 8);

  // t_k's columns: col[k][m] = sum over i + j = k of limb products of
  // quarter i of a and quarter j of b at column m
  uint64_t col[7][8];
#pragma unroll
  for (int k = 0; k < 7; ++k)
#pragma unroll
    for (int m = 0; m < 8; ++m) col[k][m] = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) col[i + j][u + v] += (uint64_t)A[4 * i + u] * B[4 * j + v];

  // L_h = t_{2h} + t_{2h+1} * 2^64
  uint32_t L[3][16];
#pragma unroll
  for (int h = 0; h < (WIDE ? 3 : 2); ++h) {
    uint64_t cols[16];
#pragma unroll
    for (int m = 0; m < 16; ++m)
      cols[m] = (m < 8 ? col[2 * h][m] : 0) + (m >= 4 && m < 12 ? col[2 * h + 1][m - 4] : 0);
    ripple(cols, L[h]);
  }

  uint32_t c_lo[16], c_hi[16], lo[16], hi[16];   // lo/hi: d (variant 256) or e (512)
  load_row(o, 4, lane, 16, c_lo);
  load_row(o, 5, lane, 16, c_hi);
  load_row(o, WIDE ? 8 : 6, lane, 16, lo);
  load_row(o, WIDE ? 9 : 7, lane, 16, hi);

  uint32_t lhs0[16], lhs1[16], t[16], carry0[16], carry1[16];
  bool eq0, eq1;
  fr_add16(L[0], c_lo, lhs0);
  half_carry(lhs0, lo, carry0, &eq0);
  fr_add16(L[1], c_hi, t);
  fr_add16(t, carry0, lhs1);
  half_carry(lhs1, hi, carry1, &eq1);

  if (!WIDE) {
    ok[lane] = below_2_72(carry0);
    ok[batch + lane] = below_2_72(carry1);
    ok[2 * batch + lane] = eq0;
    ok[3 * batch + lane] = eq1;
    // overflow = carry_hi + t4 + t5 + t6
    uint64_t cols[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) cols[m] = m < 8 ? col[4][m] + col[5][m] + col[6][m] : 0;
    uint32_t s[16], of[16];
    ripple(cols, s);
    fr_add16(carry1, s, of);
    int64_t* out = overflow + lane * 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) out[k] = (int64_t)of[k];
    return;
  }

  uint32_t d_lo[16], d_hi[16], lhs2[16], carry2[16];
  bool eq2;
  load_row(o, 6, lane, 16, d_lo);
  load_row(o, 7, lane, 16, d_hi);
  fr_add16(L[2], carry1, lhs2);
  half_carry(lhs2, d_lo, carry2, &eq2);
  // t6 + carry_2 == d_hi
  uint64_t cols[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) cols[m] = m < 8 ? col[6][m] : 0;
  uint32_t t6[16], top[16];
  ripple(cols, t6);
  fr_add16(t6, carry2, top);
  ok[lane] = below_2_72(carry0);
  ok[batch + lane] = below_2_72(carry1);
  ok[2 * batch + lane] = below_2_72(carry2);
  ok[3 * batch + lane] = eq0;
  ok[4 * batch + lane] = eq1;
  ok[5 * batch + lane] = eq2;
  ok[6 * batch + lane] = equal16(top, d_hi);
}

}  // namespace

// desc: the ten operand rows as 10 pointers, 10 lane strides and 10 widths
// (the e rows unused by variant 256); ok: [4 | 7, batch] uint8 verdicts;
// overflow: [batch, 16] int64 (variant 256 only)
extern "C" int mul_add_words_launch(int wide, const long long* desc, void* ok, void* overflow,
                                    long long batch, void* stream) {
  if (batch <= 0) return 0;
  Operands o;
  for (int k = 0; k < N_OPERANDS; ++k) {
    o.ptr[k] = (const int64_t*)desc[k];
    o.stride[k] = desc[N_OPERANDS + k];
    o.width[k] = (int)desc[2 * N_OPERANDS + k];
  }
  if (wide) {
    mul_add_words_kernel<true><<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        o, (uint8_t*)ok, (int64_t*)overflow, batch);
  } else {
    mul_add_words_kernel<false><<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        o, (uint8_t*)ok, (int64_t*)overflow, batch);
  }
  return (int)cudaGetLastError();
}
