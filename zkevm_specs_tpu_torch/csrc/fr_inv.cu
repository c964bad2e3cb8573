// K12 fr_inv: a^(p-2) mod p over the BN254 scalar field (0 maps to 0), for
// a [B|1, na] (na <= 16) of 16-bit limbs, out [B, 16] canonical.
//
// Replaces zkevm_specs_tpu/ops/fr.py:inv (:134-158; its numpy branch
// pow_const :112-127): there a lax.scan over the 254 bits of p - 2, MSB
// first, whose step is a square, a multiply by a and a select.  Here the
// same ladder runs in one thread per lane on fr_arith.cuh's Barrett
// product: the exponent is a constant, so the select is a branch that
// every thread takes alike and a 0 bit skips its multiply.  Starting from
// a at the top bit it is 253 squares and 126 multiplies; the canonical
// result is the unique a^(p-2) mod p, so it equals the JAX limbs.
//
// What bounds it on the card: at one lane (the logUp batch inverse's one
// total) the latency of 379 dependent field products; at many lanes
// integer multiply-adds, about 1900 int32 operations a product against
// 256 bytes moved a lane.
#include "fr_arith.cuh"

// p - 2 as 16 little-endian 16-bit limbs
__constant__ uint32_t c_pm2[16] = {
    0xffff, 0xefff, 0xf593, 0x43e1, 0x7091, 0x79b9, 0xe848, 0x2833,
    0x585d, 0x8181, 0x45b6, 0xb850, 0xa029, 0xe131, 0x4e72, 0x3064};

#define FR_INV_TOP_BIT 253

// out = a^(p-2) mod p by left-to-right square and multiply; out may alias a
__device__ __forceinline__ void fr_inv_ladder(const uint32_t a[16], uint32_t out[16]) {
  uint32_t base[16], acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) base[k] = acc[k] = a[k];
#pragma unroll 1
  for (int bit = FR_INV_TOP_BIT - 1; bit >= 0; --bit) {
    fr_mul16(acc, acc, acc);
    if ((c_pm2[bit >> 4] >> (bit & 15)) & 1u) fr_mul16(acc, base, acc);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) out[k] = acc[k];
}

namespace {

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
fr_inv_kernel(const int64_t* __restrict__ a, long long sa, int na, int64_t* __restrict__ out,
              long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int64_t* ar = a + lane * sa;
  uint32_t v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = limb_at(ar, k, na);
  fr_inv_ladder(v, v);
  int64_t* o = out + lane * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (int64_t)v[k];
}

}  // namespace

extern "C" int fr_inv_launch(const void* a, long long sa, int na, void* out, long long batch,
                             void* stream) {
  if (batch <= 0) return 0;
  fr_inv_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, sa, na, (int64_t*)out, batch);
  return (int)cudaGetLastError();
}
