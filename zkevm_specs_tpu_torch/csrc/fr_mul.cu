// K1 fr_mul: (a * b) mod p over the BN254 scalar field, for a [B|1, na]
// and b [B|1, nb] (na, nb <= 16) of 16-bit limbs held in int64, any values
// below 2^(16 n) (not only canonical ones), out [B, 16] canonical.
//
// Replaces zkevm_specs_tpu/ops/fr.py:mul -> reduce_wide (fr.py:43-63,
// 97-105), the live form of the retired Pallas kernel fr_mul_pallas
// (ops/pallas_fr.py:90-167 before commit 8a07970).  The canonical value
// a * b mod p is unique, so the Montgomery product below gives the same
// limbs as the JAX Barrett reduction for every input pair.
//
// What bounds it on the card: bytes.  A lane moves 128 bytes of a (16
// int64 limbs) and 128 of out against two 8 x 32-bit-limb Montgomery
// products (fr_mont.cuh, about 330 instructions each), about 5
// instructions a byte, at the card's int32 rate-to-bandwidth ratio; with a
// broadcast b, one product a lane.  A thread that reads its own lane's
// limbs makes every warp load touch 32 rows 128 bytes apart, so the design
// stages a tile of FRMUL_TILE lanes through shared memory by K3's rules
// (limb_addsub.cu), with limb_common.cuh's stage_rows:
//   1. the block loads the tile's limbs flattened (element e is lane e / n,
//      limb e % n), consecutive threads on consecutive limbs, 16 bytes a
//      thread where the base address and the row stride allow; rows sit in
//      shared memory as 32-bit words at an odd pitch (FRMUL_PITCH), so a
//      warp reading limb k of 32 lanes hits 32 banks;
//   2. one thread a lane packs its 16 limbs into eight 32-bit words and
//      multiplies:
//      - b a broadcast [1, nb] row (the logUp fingerprint's coefficients,
//        the circuits' constants): thread 0 turns b into Montgomery form
//        once, bR = mont_mul(R^2 mod p, b), while the others stage the
//        tile; each lane then takes one product, mont_mul(bR, a) = a * b
//        mod p;
//      - two varying operands (F x F): aR = mont_mul(R^2 mod p, a), then
//        mont_mul(aR, b) = a * b mod p;
//      mont_mul(x, y) is canonical for x < p and any y < 2^256, and R^2 mod
//      p and every Montgomery-form value are below p, so no operand is
//      reduced first: a and b may be any values below 2^256;
//   3. the result limbs go back into the tile in place and out as a
//      flattened, coalesced store, 16 bytes a thread.
// A broadcast a with a varying b is swapped (the product commutes).  Two
// broadcast rows take the broadcast-b kernel with one product: thread 0
// forms it in row 0, and every lane of the batch stores row 0.
#include "fr_mont.cuh"

#define FRMUL_TILE 128  // lanes (and threads) of a staged tile
#define FRMUL_PITCH 17  // 32-bit words a staged row of 16 limbs takes: odd
#ifndef FRMUL_SPLIT
#define FRMUL_SPLIT 0   // 0 the kernel; profile_replay.py --frmul's timing builds: 1 stages
                        // and stores a (no product), 2 only stages the operands
#endif
#define FR_LIMBS 16

namespace {

static_assert(2 * FRMUL_TILE * FRMUL_PITCH * 4 <= 48 * 1024,
              "two staged tiles must fit 48 KB of shared memory");

struct Args {
  StagedRow a, b;  // n <= 16 limbs a row, so copy = span = n
  int64_t* out;
  int out_vec;  // out 16-byte aligned
  long long batch;
};

// eight 32-bit words of a staged row of 16 limbs
__device__ __forceinline__ void pack_row(const uint32_t* row, uint32_t w[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = row[2 * k] | (row[2 * k + 1] << LIMB_BITS);
}

template <bool BCAST_B>
__global__ void __launch_bounds__(FRMUL_TILE) fr_mul_kernel(Args g) {
  __shared__ uint32_t sa[FRMUL_TILE * FRMUL_PITCH];
  __shared__ uint32_t sb[BCAST_B ? MONT_LIMBS : FRMUL_TILE * FRMUL_PITCH];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * FRMUL_TILE;
  const int lanes = (int)min((long long)FRMUL_TILE, g.batch - base);
  if constexpr (BCAST_B) {
    if (t == 0) {  // bR = b * R mod p, once a block, while the others stage a
      uint32_t w[MONT_LIMBS];
      mont_pack16(g.b.p, g.b.n, w);
      mont_to(w, w);
#pragma unroll
      for (int k = 0; k < MONT_LIMBS; ++k) sb[k] = w[k];
    }
  } else {
    stage_rows(g.b, sb, base, lanes, FRMUL_PITCH, FR_LIMBS);
  }
  stage_rows(g.a, sa, base, lanes, FRMUL_PITCH, FR_LIMBS);
  __syncthreads();
  // a broadcast a (and so b): one product, in row 0, for every lane
  const bool one = g.a.stride == 0;
  if (one ? t == 0 : t < lanes) {
    uint32_t* row = sa + t * FRMUL_PITCH;
    uint32_t x[MONT_LIMBS], y[MONT_LIMBS];
    pack_row(row, x);
    if constexpr (FRMUL_SPLIT == 0 && BCAST_B) {
#pragma unroll
      for (int k = 0; k < MONT_LIMBS; ++k) y[k] = sb[k];
      mont_mul(y, x, x);
    } else if constexpr (FRMUL_SPLIT == 0) {
      pack_row(sb + t * FRMUL_PITCH, y);
      mont_to(x, x);
      mont_mul(x, y, x);
    }
#pragma unroll
    for (int k = 0; k < MONT_LIMBS; ++k) {
      row[2 * k] = x[k] & LIMB_MASK;
      row[2 * k + 1] = x[k] >> LIMB_BITS;
    }
  }
  __syncthreads();
  if (FRMUL_SPLIT == 2) {  // keeps the loads (a staged limb is below 2^16)
    if (sa[t] == 0xFFFFFFFFu && sb[0] == 0xFFFFFFFFu) g.out[base * FR_LIMBS] = 0;
    return;
  }
  // rows of 16 limbs: an even element and the next share a row
  int64_t* dst = g.out + base * FR_LIMBS;
  const int total = lanes * FR_LIMBS;
#pragma unroll 4
  for (int f = 2 * t; f < total; f += 2 * FRMUL_TILE) {
    const int lane = one ? 0 : f / FR_LIMBS, k = f % FR_LIMBS;
    const int64_t v0 = sa[lane * FRMUL_PITCH + k], v1 = sa[lane * FRMUL_PITCH + k + 1];
    if (g.out_vec) {
      *reinterpret_cast<longlong2*>(dst + f) = make_longlong2(v0, v1);
    } else {
      dst[f] = v0;
      dst[f + 1] = v1;
    }
  }
}

}  // namespace

extern "C" int fr_mul_launch(const void* a, long long sa, int na, const void* b,
                             long long sb, int nb, void* out, long long batch,
                             void* stream) {
  if (batch <= 0) return 0;
  if (na < 1 || na > FR_LIMBS || nb < 1 || nb > FR_LIMBS || sa < 0 || sb < 0)
    return (int)cudaErrorInvalidValue;
  Args g;
  g.a = staged_row(a, sa, na, FR_LIMBS);
  g.b = staged_row(b, sb, nb, FR_LIMBS);
  if (sa == 0 && sb != 0) {  // the broadcast row as b
    const StagedRow t = g.a;
    g.a = g.b;
    g.b = t;
  }
  g.out = (int64_t*)out;
  g.out_vec = ((uintptr_t)out & 15) == 0;
  g.batch = batch;
  const unsigned blocks = (unsigned)((batch + FRMUL_TILE - 1) / FRMUL_TILE);
  const cudaStream_t s = (cudaStream_t)stream;
  if (g.b.stride == 0)
    fr_mul_kernel<true><<<blocks, FRMUL_TILE, 0, s>>>(g);
  else
    fr_mul_kernel<false><<<blocks, FRMUL_TILE, 0, s>>>(g);
  return (int)cudaGetLastError();
}
