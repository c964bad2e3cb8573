// K2 limb_mul: two entries on 16-bit limbs held in int64.
//
// limb_mul_launch: the unreduced narrow product of a [B|1, na] and b
// [B|1, nb] (na, nb <= 17), out [B, out_n] canonical limbs (out_n <= 34),
// the carry out of the top limb dropped: out = (a * b) mod 2^(16 out_n).
//
// limb_reduce_launch: the carry normalisation of x [R, m] (non-negative
// columns) into `keep` canonical limbs (keep <= 34), the carry out of the
// top limb dropped, x' = (sum_k x_k 2^(16 k)) mod 2^(16 keep); with
// `reduce` set (keep <= 32) then x' mod p as [R, 16] canonical limbs.
//
// Replaces zkevm_specs_tpu/ops/limbs.py:mul (limbs.py:277-327) with its
// carry_propagate (197-221) and _resolve_carries (143-194), and, for the
// second entry, carry_propagate followed by ops/fr.py:reduce_wide (fr.py:
// 43-63), as parallel/logup_shard.py:153-154 composes them.  The TPU form
// splits each product into 16-bit halves and resolves carries with a
// packed carry-lookahead, a vector-unit trick; here a lane accumulates its
// product columns in one 64-bit register (a column holds at most 17
// products < 2^32) and ripples the carry as it goes, which is exact and
// needs no second pass.
//
// The product, tile-staged.  A thread that reads its own lane's limbs makes
// every warp load and store touch 32 rows a row apart, and a [1, n]
// broadcast row would be read again by every lane.  So a block of
// MUL_THREADS threads takes a tile of MUL_TILE lanes, so that a 2048-lane
// call spreads over 64 SMs, not 8.  One tile at every batch: on an H100
// (profile_replay.py --narrow) 32 lanes is the fastest of 16, 32, 64 and
// 128 at the path's 2048-lane 1 x 16 calls; 64 lanes wins 7-11% only from
// 65536 lanes, a batch no caller makes.  A block:
//   1. the block's threads stage both operands with limb_common.cuh's
//      stage_rows: flattened 16-byte loads where the base and the row
//      stride allow, 32-bit words in shared memory at an odd pitch (cap | 1,
//      the operand's compile-time limb cap 4, 8, 16 or 17), a broadcast row
//      once a block;
//   2. one thread a lane forms its product columns in a 64-bit register
//      from shared memory and ripples the carry, writing its out_n limbs
//      into a shared output row (pitch MUL_OUT_PITCH, odd);
//   3. the tile's [lanes, out_n] block of the output goes out flattened:
//      element f is lane f / out_n, limb f % out_n, two a thread as one
//      16-byte store (the output is dense and a tile starts at an even
//      lane, so every pair is 16-byte aligned).
// What bounds the product on the card: at the path's shapes (a 2048-lane
// call of 1 x 16 limbs) the launch and one staging round; at large batches
// bytes (a lane moves (na + nb + out_n) x 8 bytes against na x nb products).
//
// The normalisation and reduction, one thread a row (the path's R is 2:
// the two sides of a logUp check).  The ripple runs over 64-bit column
// sums in the columns' order (exact for any non-negative int64 column:
// the carry stays below 2^48) and packs the limbs into sixteen 32-bit
// words, lo = words 0-7 and hi = words 8-15 of x'.  x' mod p is then
//   (lo mod p + hi * 2^256 mod p) mod p:
// hi * 2^256 mod p is fr_mont.cuh's mont_to(hi) (a Montgomery product by
// R^2 mod p, canonical for any hi < 2^256); lo < 2^256 < 6p goes below p by
// taking off 4p, 2p and p where each does not borrow, beside the product;
// one mont_add joins them.  This is chosen over a 32-bit Barrett (q1 * mu,
// then q3 * p, two wide products in series) because its dependent chain is
// one product and one reduction.  The result is x' mod p exactly, so it is
// bit-identical to reduce_wide's Barrett, which is exact for every x' <
// 2^512.  Bounded on the card by its launch and its chain
// (runtime/bounds.py:reduce_chain), not by bytes.
#include "fr_mont.cuh"

#define MUL_THREADS 128     // threads of a product block
#define MUL_TILE 32         // lanes of a tile
#define MUL_OUT_PITCH 35    // words a staged output row takes: odd, at least 34
#define REDUCE_THREADS 128  // threads (rows) of a normalisation block

namespace {

constexpr int MUL_MAX_LIMBS = 17;
constexpr int MUL_MAX_OUT = 34;

// words a staged operand row takes: odd, so a warp reading limb k of 32
// lanes hits 32 banks
__host__ __device__ constexpr int mul_pitch(int cap) { return cap | 1; }

static_assert((MUL_TILE * (2 * mul_pitch(MUL_MAX_LIMBS) + MUL_OUT_PITCH)) * 4 <= 48 * 1024,
              "a staged tile must fit 48 KB of shared memory");
static_assert(MUL_TILE % 2 == 0 && MUL_TILE <= MUL_THREADS,
              "a tile starts at an even lane and takes one thread a lane");

struct MulArgs {
  StagedRow a, b;
  int64_t* out;
  int out_n;
  unsigned out_magic;  // div_by's reciprocal of out_n
  int out_vec;         // out 16-byte aligned
  long long batch;
};

template <int CA, int CB>
__global__ void __launch_bounds__(MUL_THREADS) limb_mul_kernel(MulArgs g) {
  __shared__ uint32_t sa[MUL_TILE * mul_pitch(CA)];
  __shared__ uint32_t sb[MUL_TILE * mul_pitch(CB)];
  __shared__ uint32_t so[MUL_TILE * MUL_OUT_PITCH];
  const long long base = (long long)blockIdx.x * MUL_TILE;
  const int lanes = (int)(g.batch - base < MUL_TILE ? g.batch - base : MUL_TILE);
  const int t = threadIdx.x;
  stage_rows(g.a, sa, base, lanes, mul_pitch(CA), CA);
  stage_rows(g.b, sb, base, lanes, mul_pitch(CB), CB);
  __syncthreads();
  if (t < lanes) {
    const uint32_t* ar = sa + (g.a.stride == 0 ? 0 : t * mul_pitch(CA));
    const uint32_t* br = sb + (g.b.stride == 0 ? 0 : t * mul_pitch(CB));
    uint32_t av[CA], bv[CB];
#pragma unroll
    for (int i = 0; i < CA; ++i) av[i] = ar[i];
#pragma unroll
    for (int j = 0; j < CB; ++j) bv[j] = br[j];
    uint32_t* o = so + t * MUL_OUT_PITCH;
    uint64_t acc = 0;
#pragma unroll
    for (int k = 0; k < CA + CB; ++k) {
#pragma unroll
      for (int i = 0; i < CA; ++i) {
        const int j = k - i;
        if (j >= 0 && j < CB) acc += (uint64_t)av[i] * bv[j];
      }
      if (k < g.out_n) o[k] = (uint32_t)(acc & LIMB_MASK);
      acc >>= LIMB_BITS;
    }
    for (int k = CA + CB; k < g.out_n; ++k) o[k] = 0u;
  }
  __syncthreads();
  int64_t* dst = g.out + base * g.out_n;
  const int total = lanes * g.out_n;
  for (int f = 2 * t; f < total; f += 2 * MUL_THREADS) {
    const int lane = div_by(f, g.out_n, g.out_magic);
    const int k = f - lane * g.out_n;
    const int64_t v0 = so[lane * MUL_OUT_PITCH + k];
    if (f + 1 < total) {
      const int lane1 = k + 1 == g.out_n ? lane + 1 : lane, k1 = k + 1 == g.out_n ? 0 : k + 1;
      const int64_t v1 = so[lane1 * MUL_OUT_PITCH + k1];
      if (g.out_vec) {
        *reinterpret_cast<longlong2*>(dst + f) = make_longlong2(v0, v1);
      } else {
        dst[f] = v0;
        dst[f + 1] = v1;
      }
    } else {
      dst[f] = v0;
    }
  }
}

template <int CA, int CB>
void launch(const MulArgs& g, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((g.batch + MUL_TILE - 1) / MUL_TILE);
  limb_mul_kernel<CA, CB><<<blocks, MUL_THREADS, 0, stream>>>(g);
}

int cap_of(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 17; }

template <int CA>
void launch_b(int cb, const MulArgs& g, cudaStream_t stream) {
  switch (cb) {
    case 4: launch<CA, 4>(g, stream); break;
    case 8: launch<CA, 8>(g, stream); break;
    case 16: launch<CA, 16>(g, stream); break;
    default: launch<CA, 17>(g, stream); break;
  }
}

// 4p, 2p and p as eight little-endian 32-bit words (4p < 2^256): lo mod p
// by three subtractions, each kept where it does not borrow
__constant__ uint32_t c_p_multiples[3][MONT_LIMBS] = {
    {0xc0000004, 0x0f87d64f, 0xe6e5c245, 0xa0cfa121,
     0x06056174, 0xe14116da, 0x84c680a6, 0xc19139cb},
    {0xe0000002, 0x87c3eb27, 0xf372e122, 0x5067d090,
     0x0302b0ba, 0x70a08b6d, 0xc2634053, 0x60c89ce5},
    {0xf0000001, 0x43e1f593, 0x79b97091, 0x2833e848,
     0x8181585d, 0xb85045b6, 0xe131a029, 0x30644e72}};

// x = x - c where that does not borrow
__device__ __forceinline__ void sub_if_not_below(uint32_t x[8], const uint32_t c[8]) {
  uint32_t d[8];
  d[0] = ptx::sub_cc(x[0], c[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) d[k] = ptx::subc_cc(x[k], c[k]);
  const uint32_t borrow = ptx::subc(0u, 0u);
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = borrow ? x[k] : d[k];
}

__global__ void __launch_bounds__(REDUCE_THREADS)
limb_reduce_kernel(const int64_t* __restrict__ x, long long sx, int m,
                   int64_t* __restrict__ out, int keep, int reduce, long long rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int64_t* row = x + r * sx;
  const int cols = m < keep ? m : keep;
  if (!reduce) {
    int64_t* o = out + r * keep;
    uint64_t carry = 0;
    for (int k = 0; k < keep; ++k) {
      const uint64_t v = (k < cols ? (uint64_t)row[k] : 0ull) + carry;
      o[k] = (int64_t)(v & LIMB_MASK);
      carry = v >> LIMB_BITS;
    }
    return;
  }
  // the ripple into x' mod 2^(16 keep), packed: word j holds limbs 2j, 2j + 1
  uint32_t w[16];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint64_t v = (k < cols ? (uint64_t)row[k] : 0ull) + carry;
    const uint32_t limb = k < keep ? (uint32_t)(v & LIMB_MASK) : 0u;
    carry = v >> LIMB_BITS;
    if (k & 1) w[k >> 1] |= limb << LIMB_BITS;
    else w[k >> 1] = limb;
  }
  uint32_t lo[8], hi[8], y[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lo[k] = w[k];
    hi[k] = w[8 + k];
  }
  mont_to(hi, y);  // hi * 2^256 mod p
#pragma unroll
  for (int j = 0; j < 3; ++j) sub_if_not_below(lo, c_p_multiples[j]);
  mont_add(lo, y, lo);
  mont_unpack16(lo, out + r * 16);
}

}  // namespace

extern "C" int limb_mul_launch(const void* a, long long sa, int na, const void* b,
                               long long sb, int nb, void* out, int out_n,
                               long long batch, void* stream) {
  if (batch <= 0) return 0;
  if (na < 1 || na > MUL_MAX_LIMBS || nb < 1 || nb > MUL_MAX_LIMBS || out_n < 1 ||
      out_n > MUL_MAX_OUT || sa < 0 || sb < 0)
    return (int)cudaErrorInvalidValue;
  MulArgs g;
  const int ca = cap_of(na), cb = cap_of(nb);
  g.a = staged_row(a, sa, na, ca);
  g.b = staged_row(b, sb, nb, cb);
  g.out = (int64_t*)out;
  g.out_n = out_n;
  g.out_magic = host_magic(out_n);
  g.out_vec = ((uintptr_t)out & 15) == 0;
  g.batch = batch;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ca) {
    case 4: launch_b<4>(cb, g, s); break;
    case 8: launch_b<8>(cb, g, s); break;
    case 16: launch_b<16>(cb, g, s); break;
    default: launch_b<17>(cb, g, s); break;
  }
  return (int)cudaGetLastError();
}

// x: [rows, m] int64 columns (non-negative), row stride sx; out: [rows,
// keep] (reduce 0) or [rows, 16] (reduce 1, keep <= 32)
extern "C" int limb_reduce_launch(const void* x, long long sx, int m, void* out, int keep,
                                  int reduce, long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (m < 1 || keep < 1 || keep > (reduce ? 32 : MUL_MAX_OUT) || sx < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + REDUCE_THREADS - 1) / REDUCE_THREADS);
  limb_reduce_kernel<<<blocks, REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, sx, m, (int64_t*)out, keep, reduce, rows);
  return (int)cudaGetLastError();
}
