// K8 horner_rlc: the byte random linear combination of each row of a
// batch, acc <- (acc * r + byte) mod p over the active steps, for byte
// columns bytes [T, n] (uint8), an activity mask active [T, n] (bool) and a
// static canonical r (16 limbs, passed by value); out [n, 16] canonical
// limbs of the BN254 scalar field.
//
// Replaces zkevm_specs_tpu/circuits/keccak.py:_horner_rlc (:44-74): there a
// lax.scan whose step is L.mul by r's limbs, L.add of the byte, then
// fr.reduce_wide, masked by active.  Each step's result is the canonical
// residue of acc * r + byte (< p^2, so the Barrett step of fr_arith.cuh,
// shared with K1, reduces it exactly), which equals the JAX limbs.
//
// What bounds it on the card: for a few long rows (the ALU block: 8 rows of
// 66001 bytes) the latency of the dependent chain of T multiply-adds of
// one row; for many short rows (a SHA3-heavy block's table) integer
// multiply-adds, about 700 32x32->64-bit products a step against 2 bytes
// read.  The design is one thread per row: acc and r stay in registers
// for the whole scan, the steps of a row run in order inside the thread,
// and step j of neighbouring rows reads neighbouring bytes (coalesced).
// An inactive step reads its mask byte and does nothing.
#include <string.h>

#include "fr_arith.cuh"

namespace {

struct Limbs16 {
  uint32_t v[16];
};

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
horner_rlc_kernel(const uint8_t* __restrict__ bytes, const bool* __restrict__ active,
                  long long T, long long n, Limbs16 r, int64_t* __restrict__ out) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  uint32_t acc[16], x[32];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
#pragma unroll 1
  for (long long j = 0; j < T; ++j) {
    const long long at = j * n + row;
    if (!active[at]) continue;
    fr_product(acc, r.v, (uint32_t)bytes[at], x);
    fr_barrett(x, acc);
  }
  int64_t* o = out + row * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) o[k] = (int64_t)acc[k];
}

}  // namespace

extern "C" int horner_rlc_launch(const void* bytes, const void* active, long long T, long long n,
                                 const void* r_limbs, void* out, void* stream) {
  if (n <= 0) return 0;
  if (T < 0 || r_limbs == nullptr) return (int)cudaErrorInvalidValue;
  Limbs16 r;
  memcpy(r.v, r_limbs, sizeof(r.v));  // host array of 16 uint32 limbs
  horner_rlc_kernel<<<grid_for(n), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bytes, (const bool*)active, T, n, r, (int64_t*)out);
  return (int)cudaGetLastError();
}
