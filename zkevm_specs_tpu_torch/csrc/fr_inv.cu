// K12 fr_inv: a^(p-2) mod p over the BN254 scalar field (0 maps to 0), for
// a [B|1, na] (na <= 16) of 16-bit limbs, out [B, 16] canonical.
//
// Replaces zkevm_specs_tpu/ops/fr.py:inv (:134-158; its numpy branch
// pow_const :112-127): there a lax.scan over the 254 bits of p - 2, MSB
// first, whose step is a square, a multiply by a and a select.  Here one
// thread a lane runs the left-to-right sliding-window chain of width 4 for
// p - 2 on fr_mont.cuh's 32-bit-limb Montgomery product: the table a, a^3,
// ..., a^15 (one squaring, 7 multiplies) in registers, then per window its
// squarings (each a dedicated squaring) and one multiply by a table entry:
// 253 squarings and 56 multiplies in all, against the binary ladder's 253
// and 126.  The exponent is fixed, so the schedule is a constant table
// below (ops/fr.py:sliding_window_schedule generates it;
// tests/test_torch_fr_mont.py checks it); p - 2 is odd, so the chain ends
// on a multiply.  The canonical result is the unique a^(p-2) mod p, so it
// equals the JAX limbs.
//
// What bounds it on the card: at one lane (the logUp batch inverse's one
// total) the latency of 303 dependent field products; at many lanes
// integer multiply-adds, about 300 instructions a product against 256
// bytes moved a lane.
#include "fr_mont.cuh"

#define FR_INV_TABLE 8       // a^(2k+1), k < 8: the odd powers below 2^4
#define FR_INV_FIRST 1       // the chain starts from a^3
#define FR_INV_WINDOWS 49

// per window after the first: the squarings, then the table entry to
// multiply by
__constant__ uint8_t c_inv_squares[FR_INV_WINDOWS] = {
    7, 3, 7, 2, 5, 6, 1, 8, 1, 7, 10, 6, 2, 7, 6, 7, 5, 3, 8, 9, 3, 8, 3, 5, 7,
    6, 3, 8, 8, 6, 2, 6, 1, 8, 6, 8, 1, 8, 3, 3, 6, 4, 5, 4, 4, 4, 4, 4, 4};
__constant__ uint8_t c_inv_index[FR_INV_WINDOWS] = {
    1, 0, 4, 1, 3, 5, 0, 4, 0, 6, 2, 6, 1, 2, 0, 5, 6, 2, 1, 2, 1, 5, 2, 2, 1,
    7, 2, 4, 7, 6, 1, 5, 0, 4, 2, 7, 0, 7, 2, 1, 4, 7, 7, 7, 7, 7, 7, 7, 7};

// out = a^(p-2) in Montgomery form, for a in Montgomery form; out may
// alias a
__device__ __forceinline__ void fr_inv_mont(const uint32_t a[8], uint32_t out[8]) {
  uint32_t tab[FR_INV_TABLE][8], a2[8], acc[8];
  mont_sqr(a, a2);
#pragma unroll
  for (int k = 0; k < 8; ++k) tab[0][k] = a[k];
#pragma unroll
  for (int e = 1; e < FR_INV_TABLE; ++e) mont_mul(tab[e - 1], a2, tab[e]);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = tab[FR_INV_FIRST][k];
#pragma unroll 1
  for (int w = 0; w < FR_INV_WINDOWS; ++w) {
#pragma unroll 1
    for (int s = c_inv_squares[w]; s > 0; --s) mont_sqr(acc, acc);
    // the entry by predicated selects, so the table stays in registers
    const int idx = c_inv_index[w];
    uint32_t f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = tab[0][k];
#pragma unroll
    for (int e = 1; e < FR_INV_TABLE; ++e) {
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = e == idx ? tab[e][k] : f[k];
    }
    mont_mul(acc, f, acc);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = acc[k];
}

namespace {

__global__ void __launch_bounds__(THREADS_PER_BLOCK, 2)
fr_inv_kernel(const int64_t* __restrict__ a, long long sa, int na, int64_t* __restrict__ out,
              long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  uint32_t v[8], m[8];
  mont_pack16(a + lane * sa, na, v);
  mont_to(v, m);
  fr_inv_mont(m, m);
  mont_from(m, v);
  mont_unpack16(v, out + lane * 16);
}

}  // namespace

extern "C" int fr_inv_launch(const void* a, long long sa, int na, void* out, long long batch,
                             void* stream) {
  if (batch <= 0) return 0;
  fr_inv_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, sa, na, (int64_t*)out, batch);
  return (int)cudaGetLastError();
}
