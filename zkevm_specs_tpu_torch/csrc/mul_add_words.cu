// K11 mul_add_words: the 512-bit word product a * b + c of 256-bit words and
// the carry constraints of the EVM circuit's arithmetic gadgets.
//
// Replaces the XLA computation of zkevm_specs_tpu/evm/instruction.py:
// _mul_512_terms (:812), mul_add_words (:827) and mul_add_words_512 (:845),
// and circuits/exp.py:_mul_add_words (:19), which the JAX package runs as a
// chain of some forty field operations.  Each word is lo/hi (two [B|1, w]
// rows of canonical 16-bit limbs held in int64, w <= 16, each value below
// p); a, b, c, d (and e) are the ten rows of `Args`, a [1, w] constant row
// given stride 0.
//
//   a64, b64  the 64-bit quarters (lo mod 2^64, (lo >> 64) mod 2^64, the
//             same of hi), as Word.to_64s gives them (limbs above 8 drop);
//   t0..t6    t_k = sum_{i+j=k} a64_i * b64_j, exact (< 2^130);
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
// values, as the F chain takes them (fr.add/sub/mul).  A negative
// difference wraps mod p, so its carry is a 254-bit field value that fails
// the 72-bit check, as in the chain.  In the field the equalities hold for
// every canonical input; the kernel still computes them as the chain does.
//
// The arithmetic is fr_mont.cuh's, on eight 32-bit words a value:
//   - the t_k are 64 limb products, each 64-bit pair product a 2 x 2-word
//     schoolbook of mad.lo/mad.hi on PTX carry chains (mac64), added into
//     t_k's five words;
//   - an Fr add or subtract is mont_add / mont_sub, an 8-word carry chain
//     and p taken off (or put back) once;
//   - x * 2^-128 mod p is mont_mul(2^128, x), the constant 2^-128 in
//     Montgomery form first: its wide product is x moved up four words,
//     so the kernel reduces that (mont_reduce) and skips the product;
//   - carry * 2^128 mod p is mont_mul(2^384 mod p, carry), 2^128 in
//     Montgomery form first.
// mont_mul(a, b) is canonical for a < p and any b < 2^256 (fr_mont.cuh),
// and every first factor above is a constant below p.
//
// What bounds it on the card: bytes at large batches (a lane reads up to
// 10 rows of 16 limbs and writes 4 or 7 verdict bytes and 128 bytes of
// overflow, against about 1300 integer instructions), one lane's chain of
// dependent carries at small ones.  A thread that reads its own lane's
// limbs makes every warp load touch 32 rows a row apart, so the design
// stages a tile of lanes as K1 (fr_mul.cu) does, with limb_common.cuh's
// stage_rows:
//   1. the block's threads load the tile's rows flattened (element e is
//      lane e / span, limb e % span), 16 bytes a thread where the base
//      address and the row stride allow, a [1, w] row once a block; each
//      limb goes into shared memory as a 16-bit half, so a row's words sit
//      packed, at an odd pitch of 32-bit words (5 for a quarter row, 9 for
//      a field row), and a warp reading word j of 32 lanes hits 32 banks;
//   2. one thread a lane runs the arithmetic above from shared memory and
//      writes its verdict bytes (a warp's 32 lanes, one sector a check);
//   3. the 256 variant's overflow words go back into shared memory and
//      out as 16 int64 limbs a lane, a flattened store, 16 bytes a thread.
// Under WORDMUL_SMALL_BATCH lanes a block takes WORDMUL_SMALL_TILE lanes
// with the same threads, so a 2048-lane call spreads over 64 SMs, not 16,
// and four threads share each lane's loads.  (Measured and dropped: every
// row's loads issued before any is staged, and the equalities on the small
// tile's free warps; both ran slower.)
#include "fr_mont.cuh"

#define WORDMUL_THREADS 128     // threads of a block
#define WORDMUL_TILE 128        // lanes of a tile from WORDMUL_SMALL_BATCH lanes
#define WORDMUL_SMALL_TILE 32   // lanes of a tile under it
#ifndef WORDMUL_SMALL_BATCH
#define WORDMUL_SMALL_BATCH 32768
#endif
#define QUARTER_LIMBS 8         // limbs of a, b a lane uses (two quarters a row)
#define QUARTER_PITCH 5         // words a staged quarter row takes: odd
#define FIELD_PITCH 9           // words a staged field row of 16 limbs takes: odd

namespace {

constexpr int N_OPERANDS = 10;  // a.lo a.hi b.lo b.hi c.lo c.hi d.lo d.hi e.lo e.hi
constexpr int N_QUARTER_ROWS = 4;
constexpr int N_FIELD_ROWS = N_OPERANDS - N_QUARTER_ROWS;

static_assert((N_QUARTER_ROWS * QUARTER_PITCH + (N_FIELD_ROWS + 1) * FIELD_PITCH) *
                      WORDMUL_TILE * 4 <= 48 * 1024,
              "a staged tile must fit 48 KB of shared memory");

// 2^384 mod p: 2^128 in Montgomery form, the first factor of carry * 2^128
__constant__ uint32_t c_wm_pow128[MONT_LIMBS] = {
    0xef8cfeb9, 0xb075da81, 0xa5b6cd8c, 0xa7f12acc,
    0x7957bf7b, 0x32c47504, 0x48ffa25e, 0x03d581d7};

struct Args {
  StagedRow row[N_OPERANDS];  // the first 8 limbs of a, b; 16 of the others
  uint8_t* ok;         // [4 | 7, batch]
  int64_t* overflow;   // [batch, 16] (variant 256)
  int overflow_vec;    // overflow 16-byte aligned
  long long batch;
};

// t += a * b for 64-bit a = (a0, a1), b = (b0, b1) and a five-word t that
// stays below 2^160 (a t_k is below 2^130): the limb products' words in
// three carry chains, each carry into t[4]
__device__ __forceinline__ void mac64(uint32_t a0, uint32_t a1, uint32_t b0, uint32_t b1,
                                      uint32_t t[5]) {
  t[0] = ptx::mad_lo_cc(a0, b0, t[0]);
  t[1] = ptx::madc_hi_cc(a0, b0, t[1]);
  t[2] = ptx::madc_lo_cc(a1, b1, t[2]);
  t[3] = ptx::madc_hi_cc(a1, b1, t[3]);
  t[4] = ptx::addc(t[4], 0u);
  t[1] = ptx::mad_lo_cc(a0, b1, t[1]);
  t[2] = ptx::madc_hi_cc(a0, b1, t[2]);
  t[3] = ptx::addc_cc(t[3], 0u);
  t[4] = ptx::addc(t[4], 0u);
  t[1] = ptx::mad_lo_cc(a1, b0, t[1]);
  t[2] = ptx::madc_hi_cc(a1, b0, t[2]);
  t[3] = ptx::addc_cc(t[3], 0u);
  t[4] = ptx::addc(t[4], 0u);
}

// L = lo + hi * 2^64 for five-word lo, hi (below 2^195: exact in 8 words)
__device__ __forceinline__ void pair_sum(const uint32_t lo[5], const uint32_t hi[5],
                                         uint32_t L[8]) {
  L[0] = lo[0];
  L[1] = lo[1];
  L[2] = ptx::add_cc(lo[2], hi[0]);
  L[3] = ptx::addc_cc(lo[3], hi[1]);
  L[4] = ptx::addc_cc(lo[4], hi[2]);
  L[5] = ptx::addc_cc(0u, hi[3]);
  L[6] = ptx::addc_cc(0u, hi[4]);
  L[7] = ptx::addc(0u, 0u);
}

// out = x * 2^-128 mod p, canonical, for x < 2^256: mont_mul(2^128, x),
// whose wide product is x moved up four words
__device__ __forceinline__ void mul_inv128(const uint32_t x[8], uint32_t out[8]) {
  uint32_t t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = (k >= 4 && k < 12) ? x[k - 4] : 0u;
  mont_reduce(t, out);
}

// the carry of one 128-bit half: carry = (lhs - rhs) * 2^-128 (mod p)
__device__ __forceinline__ void carry_of(const uint32_t lhs[8], const uint32_t rhs[8],
                                         uint32_t carry[8]) {
  uint32_t diff[8];
  mont_sub(lhs, rhs, diff);
  mul_inv128(diff, carry);
}

// the half's equality lhs == rhs + carry * 2^128 (mod p)
__device__ __forceinline__ bool equality(const uint32_t lhs[8], const uint32_t rhs[8],
                                         const uint32_t carry[8]) {
  uint32_t pow128[8], back[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) pow128[k] = c_wm_pow128[k];
  mont_mul(pow128, carry, back);
  mont_add(rhs, back, back);
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) ok = ok && lhs[k] == back[k];
  return ok;
}

__device__ __forceinline__ bool below_2_72(const uint32_t v[8]) {
  bool ok = v[2] < 256u;
#pragma unroll
  for (int k = 3; k < 8; ++k) ok = ok && v[k] == 0u;
  return ok;
}

__device__ __forceinline__ void load_words(const uint32_t* row, int n, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < n; ++k) w[k] = row[k];
}

template <bool WIDE, int TILE>
__global__ void __launch_bounds__(WORDMUL_THREADS) mul_add_words_kernel(Args g) {
  __shared__ uint32_t sq[N_QUARTER_ROWS * TILE * QUARTER_PITCH];
  __shared__ uint32_t sf[N_FIELD_ROWS * TILE * FIELD_PITCH];
  __shared__ uint32_t so[WIDE ? 1 : TILE * FIELD_PITCH];
  const long long base = (long long)blockIdx.x * TILE;
  const int lanes = (int)min((long long)TILE, g.batch - base);
#pragma unroll
  for (int r = 0; r < N_QUARTER_ROWS; ++r)
    stage_rows(g.row[r], reinterpret_cast<uint16_t*>(sq + r * TILE * QUARTER_PITCH), base, lanes,
               2 * QUARTER_PITCH, QUARTER_LIMBS);
#pragma unroll
  for (int r = 0; r < (WIDE ? N_FIELD_ROWS : N_FIELD_ROWS - 2); ++r)
    stage_rows(g.row[N_QUARTER_ROWS + r], reinterpret_cast<uint16_t*>(sf + r * TILE * FIELD_PITCH),
               base, lanes, 2 * FIELD_PITCH, 16);
  __syncthreads();

  const int t = threadIdx.x;
  const long long n = g.batch;
  auto field = [&](int r, int lane) {
    return sf + r * TILE * FIELD_PITCH +
           (g.row[N_QUARTER_ROWS + r].stride == 0 ? 0 : lane * FIELD_PITCH);
  };
  // half h's rhs row (d_lo, d_hi in variant 256; e_lo, e_hi, d_lo in 512)
  // and its equality's verdict row
  auto rhs_row = [](int h) { return WIDE ? (h == 2 ? 2 : 4 + h) : 2 + h; };
  auto eq_row = [](int h) { return WIDE ? 3 + h : 2 + h; };
  if (t < lanes) {
    auto quarter = [&](int r) {
      return sq + r * TILE * QUARTER_PITCH + (g.row[r].stride == 0 ? 0 : t * QUARTER_PITCH);
    };
    // the quarters as word pairs: a64_i = (A[2i], A[2i + 1]); lo's words
    // 0..3, then hi's
    uint32_t A[8], B[8];
    load_words(quarter(0), 4, A);
    load_words(quarter(1), 4, A + 4);
    load_words(quarter(2), 4, B);
    load_words(quarter(3), 4, B + 4);
    uint32_t tk[7][5];
#pragma unroll
    for (int k = 0; k < 7; ++k)
#pragma unroll
      for (int m = 0; m < 5; ++m) tk[k][m] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mac64(A[2 * i], A[2 * i + 1], B[2 * j], B[2 * j + 1], tk[i + j]);

    uint8_t* ok = g.ok + base + t;
    // half h: its carry against its rhs row, the range check and the equality
    auto half = [&](int h, const uint32_t lhs[8], uint32_t carry[8]) {
      uint32_t rhs[8];
      load_words(field(rhs_row(h), t), 8, rhs);
      carry_of(lhs, rhs, carry);
      ok[h * n] = below_2_72(carry);
      ok[eq_row(h) * n] = equality(lhs, rhs, carry);
    };
    uint32_t x[8], y[8], lhs[8], carry0[8], carry1[8];
    // lhs_lo = L0 + c_lo
    pair_sum(tk[0], tk[1], x);
    load_words(field(0, t), 8, y);
    mont_add(x, y, lhs);
    half(0, lhs, carry0);
    // lhs_hi = L1 + c_hi + carry_lo
    pair_sum(tk[2], tk[3], x);
    load_words(field(1, t), 8, y);
    mont_add(x, y, x);
    mont_add(x, carry0, lhs);
    half(1, lhs, carry1);
    if constexpr (!WIDE) {
      // overflow = carry_hi + (t4 + t5 + t6), the sum exact (< 2^132)
      uint32_t s[8];
      s[0] = ptx::add_cc(tk[4][0], tk[5][0]);
#pragma unroll
      for (int m = 1; m < 5; ++m) s[m] = ptx::addc_cc(tk[4][m], tk[5][m]);
      s[5] = ptx::addc(0u, 0u);
      s[0] = ptx::add_cc(s[0], tk[6][0]);
#pragma unroll
      for (int m = 1; m < 5; ++m) s[m] = ptx::addc_cc(s[m], tk[6][m]);
      s[5] = ptx::addc(s[5], 0u);
      s[6] = s[7] = 0u;
      mont_add(carry1, s, s);
#pragma unroll
      for (int k = 0; k < 8; ++k) so[t * FIELD_PITCH + k] = s[k];
    } else {
      // lhs2 = L2 + carry_1; t6 + carry_2 == d_hi
      uint32_t carry2[8];
      pair_sum(tk[4], tk[5], x);
      mont_add(x, carry1, lhs);
      half(2, lhs, carry2);
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = k < 5 ? tk[6][k] : 0u;
      mont_add(x, carry2, x);
      load_words(field(3, t), 8, y);
      bool top = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) top = top && x[k] == y[k];
      ok[6 * n] = top;
    }
  }
  if constexpr (!WIDE) {
    __syncthreads();
    // the overflow rows, 16 limbs a lane: limbs 2j and 2j + 1 are the
    // halves of word j, one 16-byte store
    int64_t* dst = g.overflow + base * 16;
    const int total = lanes * 16;
#pragma unroll 4
    for (int f = 2 * t; f < total; f += 2 * WORDMUL_THREADS) {
      const uint32_t w = so[(f >> 4) * FIELD_PITCH + ((f & 15) >> 1)];
      const int64_t v0 = w & LIMB_MASK, v1 = w >> LIMB_BITS;
      if (g.overflow_vec) {
        *reinterpret_cast<longlong2*>(dst + f) = make_longlong2(v0, v1);
      } else {
        dst[f] = v0;
        dst[f + 1] = v1;
      }
    }
  }
}

template <bool WIDE>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  if (g.batch < WORDMUL_SMALL_BATCH) {
    const unsigned blocks = (unsigned)((g.batch + WORDMUL_SMALL_TILE - 1) / WORDMUL_SMALL_TILE);
    mul_add_words_kernel<WIDE, WORDMUL_SMALL_TILE><<<blocks, WORDMUL_THREADS, 0, stream>>>(g);
  } else {
    const unsigned blocks = (unsigned)((g.batch + WORDMUL_TILE - 1) / WORDMUL_TILE);
    mul_add_words_kernel<WIDE, WORDMUL_TILE><<<blocks, WORDMUL_THREADS, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

}  // namespace

// desc: the ten operand rows as 10 pointers, 10 lane strides and 10 widths
// (the e rows unused by variant 256); ok: [4 | 7, batch] uint8 verdicts;
// overflow: [batch, 16] int64 (variant 256 only)
extern "C" int mul_add_words_launch(int wide, const long long* desc, void* ok, void* overflow,
                                    long long batch, void* stream) {
  if (batch <= 0) return 0;
  Args g;
  for (int k = 0; k < N_OPERANDS; ++k) {
    const int n = (int)desc[2 * N_OPERANDS + k];
    if (n < 1 || n > 16 || desc[N_OPERANDS + k] < 0) return (int)cudaErrorInvalidValue;
    g.row[k] = staged_row((const void*)desc[k], desc[N_OPERANDS + k], n,
                          k < N_QUARTER_ROWS ? QUARTER_LIMBS : 16);
  }
  g.ok = (uint8_t*)ok;
  g.overflow = (int64_t*)overflow;
  g.overflow_vec = ((uintptr_t)overflow & 15) == 0;
  g.batch = batch;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(wide ? launch<true>(g, s) : launch<false>(g, s));
}
