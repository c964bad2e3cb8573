// K3 limb_addsub: the carry and borrow chains over 16-bit limbs, for
// a [B|1, na] and b [B|1, nb], in four modes:
//   0 ADD     out [B, out_n] = (a + b) mod 2^(16 out_n)
//   1 SUB     out [B, n] = (a - b) mod 2^(16 n), n = max(na, nb), and
//             borrow [B] = 1 where a < b
//   2 FR_ADD  s = (a + b) mod 2^272; out [B, 16] = low 16 limbs of
//             (s >= p ? s - p : s)  (reduce_once when b = 0)
//   3 FR_SUB  d = (a - b) mod 2^256; out [B, 16] = borrow ? (d + p) mod
//             2^256 : d  (fr.neg when a = 0)
//
// Replaces zkevm_specs_tpu/ops/limbs.py:add and sub (limbs.py:228-252) and
// ops/fr.py:add, sub, neg and reduce_once (fr.py:66-94).  The TPU form
// resolves each chain with a packed carry-lookahead per 16-limb chunk, a
// vector-unit trick; one thread per lane rippling the carry through its
// limbs is the natural GPU form and is exact.
//
// What bounds it on the card: bytes.  A lane does a few integer operations
// per limb against 16 to 24 bytes of limbs read and 8 written, far below
// the card's operations-per-byte line.  The design reads each operand limb
// once and writes each result limb once; the plain modes keep no limb
// array at all, and the Fr modes hold their 17 limbs in registers.
#include "limb_common.cuh"

namespace {

constexpr int MODE_ADD = 0;
constexpr int MODE_SUB = 1;
constexpr int MODE_FR_ADD = 2;
constexpr int MODE_FR_SUB = 3;

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
limb_addsub_kernel(const int64_t* __restrict__ a, long long sa, int na,
                   const int64_t* __restrict__ b, long long sb, int nb,
                   int64_t* __restrict__ out, int out_n,
                   int64_t* __restrict__ borrow_out, int mode, long long batch) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= batch) return;
  const int64_t* ar = a + lane * sa;
  const int64_t* br = b + lane * sb;
  int64_t* o = out + lane * (long long)out_n;

  if (mode == MODE_ADD) {
    uint32_t carry = 0;
    for (int k = 0; k < out_n; ++k) {
      const uint32_t s = limb_at(ar, k, na) + limb_at(br, k, nb) + carry;
      o[k] = (int64_t)(s & LIMB_MASK);
      carry = s >> LIMB_BITS;
    }
  } else if (mode == MODE_SUB) {
    int borrow = 0;
    for (int k = 0; k < out_n; ++k) {
      const int v = (int)limb_at(ar, k, na) - (int)limb_at(br, k, nb) - borrow;
      o[k] = (int64_t)((uint32_t)v & LIMB_MASK);
      borrow = v < 0;
    }
    borrow_out[lane] = borrow;
  } else if (mode == MODE_FR_ADD) {
    uint32_t s[17];
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const uint32_t v = limb_at(ar, k, na) + limb_at(br, k, nb) + carry;
      s[k] = v & LIMB_MASK;
      carry = v >> LIMB_BITS;
    }
    uint32_t d[16];
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const int v = (int)s[k] - (int)c_p17[k] - borrow;
      if (k < 16) d[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) o[k] = (int64_t)(borrow ? s[k] : d[k]);
  } else {  // MODE_FR_SUB
    uint32_t d[16];
    int borrow = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int v = (int)limb_at(ar, k, na) - (int)limb_at(br, k, nb) - borrow;
      d[k] = (uint32_t)v & LIMB_MASK;
      borrow = v < 0;
    }
    const uint32_t add_p = borrow ? 1u : 0u;
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t v = d[k] + add_p * c_p17[k] + carry;
      o[k] = (int64_t)(v & LIMB_MASK);
      carry = v >> LIMB_BITS;
    }
  }
}

}  // namespace

extern "C" int limb_addsub_launch(const void* a, long long sa, int na, const void* b,
                                  long long sb, int nb, void* out, int out_n,
                                  void* borrow_out, int mode, long long batch,
                                  void* stream) {
  if (batch <= 0) return 0;
  if (mode < MODE_ADD || mode > MODE_FR_SUB || (mode == MODE_SUB && borrow_out == nullptr) ||
      out_n < 1 || na < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  limb_addsub_kernel<<<grid_for(batch), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, sa, na, (const int64_t*)b, sb, nb, (int64_t*)out, out_n,
      (int64_t*)borrow_out, mode, batch);
  return (int)cudaGetLastError();
}
