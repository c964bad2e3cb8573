// K1 fr_mul: (a * b) mod p over the BN254 scalar field, for a [B|1, na]
// and b [B|1, nb] (na, nb <= 16) of 16-bit limbs, out [B, 16] canonical.
//
// Replaces zkevm_specs_tpu/ops/fr.py:mul -> reduce_wide (fr.py:43-63,
// 97-105), the live form of the retired Pallas kernel fr_mul_pallas
// (ops/pallas_fr.py:90-167 before commit 8a07970).  The result is
// bit-identical to that Barrett reduction for every input pair: the same
// 32-limb product, q1 = x >> 240, q3 = (q1 * mu) >> 272,
// r = (x - q3 * p) mod 2^272, then p subtracted at most twice (the shared
// arithmetic of fr_arith.cuh).
//
// What bounds it on the card: integer multiply-adds.  One lane does
// 256 + 289 + 153 = 698 32x32->64-bit products against 256 bytes read and
// 128 written, about 2.7 products per byte, above the card's int32
// rate-to-bandwidth ratio.  The design keeps every limb of a lane in
// registers (one thread per lane), and touches device memory only to read
// the operands and write the 16 result limbs.
#include "fr_arith.cuh"

namespace {

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
fr_mul_kernel(const int64_t* __restrict__ a, long long sa, int na,
              const int64_t* __restrict__ b, long long sb, int nb,
              int64_t* __restrict__ out, long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int64_t* ar = a + lane * sa;
  const int64_t* br = b + lane * sb;

  uint32_t av[16], bv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    av[i] = limb_at(ar, i, na);
    bv[i] = limb_at(br, i, nb);
  }
  uint32_t x[32], r[16];
  fr_product(av, bv, 0u, x);
  fr_barrett(x, r);

  int64_t* o = out + lane * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (int64_t)r[k];
}

}  // namespace

extern "C" int fr_mul_launch(const void* a, long long sa, int na, const void* b,
                             long long sb, int nb, void* out, long long batch,
                             void* stream) {
  if (batch <= 0) return 0;
  fr_mul_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, sa, na, (const int64_t*)b, sb, nb, (int64_t*)out, batch);
  return (int)cudaGetLastError();
}
