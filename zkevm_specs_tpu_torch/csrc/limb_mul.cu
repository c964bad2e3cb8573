// K2 limb_mul: the unreduced narrow product of a [B|1, na] and b [B|1, nb]
// (na, nb <= 17) of 16-bit limbs, out [B, out_n] canonical limbs
// (out_n <= 34), the carry out of the top limb dropped:
// out = (a * b) mod 2^(16 out_n).
//
// Replaces zkevm_specs_tpu/ops/limbs.py:mul (limbs.py:277-327) with its
// carry_propagate (197-221) and _resolve_carries (143-194).  The TPU form
// splits each product into 16-bit halves and resolves carries with a
// packed carry-lookahead, a vector-unit trick; here a lane accumulates its
// product columns in one 64-bit register (a column holds at most 17
// products < 2^32) and ripples the carry as it goes, which is exact and
// needs no second pass.
//
// What bounds it on the card: at the path's widths (4x4 and 16x8 limbs) a
// lane does 16 to 128 products against 64 to 192 bytes moved, so it sits
// near the line between bytes and integer operations.  The design keeps
// the operands in registers (compile-time limb caps of 4, 8, 16 or 17 per
// operand, loops fully unrolled) and reads each operand limb once.
#include "limb_common.cuh"

namespace {

template <int CA, int CB>
__global__ void __launch_bounds__(THREADS_PER_BLOCK)
limb_mul_kernel(const int64_t* __restrict__ a, long long sa, int na,
                const int64_t* __restrict__ b, long long sb, int nb,
                int64_t* __restrict__ out, int out_n, long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int64_t* ar = a + lane * sa;
  const int64_t* br = b + lane * sb;
  int64_t* o = out + lane * (long long)out_n;

  uint32_t av[CA], bv[CB];
#pragma unroll
  for (int i = 0; i < CA; ++i) av[i] = limb_at(ar, i, na);
#pragma unroll
  for (int j = 0; j < CB; ++j) bv[j] = limb_at(br, j, nb);

  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < CA + CB; ++k) {
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      const int j = k - i;
      if (j >= 0 && j < CB) acc += (uint64_t)av[i] * bv[j];
    }
    if (k < out_n) o[k] = (int64_t)(acc & LIMB_MASK);
    acc >>= LIMB_BITS;
  }
  for (int k = CA + CB; k < out_n; ++k) o[k] = 0;
}

template <int CA, int CB>
void launch(const void* a, long long sa, int na, const void* b, long long sb, int nb,
            void* out, int out_n, long long batch, cudaStream_t stream) {
  limb_mul_kernel<CA, CB><<<grid_for(batch), THREADS_PER_BLOCK, 0, stream>>>(
      (const int64_t*)a, sa, na, (const int64_t*)b, sb, nb, (int64_t*)out, out_n, batch);
}

int cap_of(int n) { return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 17; }

template <int CA>
void launch_b(int cb, const void* a, long long sa, int na, const void* b, long long sb,
              int nb, void* out, int out_n, long long batch, cudaStream_t stream) {
  switch (cb) {
    case 4: launch<CA, 4>(a, sa, na, b, sb, nb, out, out_n, batch, stream); break;
    case 8: launch<CA, 8>(a, sa, na, b, sb, nb, out, out_n, batch, stream); break;
    case 16: launch<CA, 16>(a, sa, na, b, sb, nb, out, out_n, batch, stream); break;
    default: launch<CA, 17>(a, sa, na, b, sb, nb, out, out_n, batch, stream); break;
  }
}

}  // namespace

extern "C" int limb_mul_launch(const void* a, long long sa, int na, const void* b,
                               long long sb, int nb, void* out, int out_n,
                               long long batch, void* stream) {
  if (batch <= 0) return 0;
  if (na < 1 || na > 17 || nb < 1 || nb > 17 || out_n < 1 || out_n > 34)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (cap_of(na)) {
    case 4: launch_b<4>(cap_of(nb), a, sa, na, b, sb, nb, out, out_n, batch, s); break;
    case 8: launch_b<8>(cap_of(nb), a, sa, na, b, sb, nb, out, out_n, batch, s); break;
    case 16: launch_b<16>(cap_of(nb), a, sa, na, b, sb, nb, out, out_n, batch, s); break;
    default: launch_b<17>(cap_of(nb), a, sa, na, b, sb, nb, out, out_n, batch, s); break;
  }
  return (int)cudaGetLastError();
}
