// K7 keccak_sponge: the keccak-256 sponge of each row of a batch.  Row i
// absorbs its first n_blocks[i] rate blocks (blocks [n, max_blocks, 34],
// the padded preimage as little-endian 32-bit words held in int64) and
// writes the first four lanes of its state, as 32-bit words, to out [n, 8]
// (lo, hi of lane 0, then lane 1, ...).
//
// Replaces zkevm_specs_tpu/ops/keccak.py:keccak_f_lanes (:171, the
// lax.scan of keccak_round :136 over u32 lo/hi lane pairs) inside the
// absorb loop of circuits/keccak.py:check_keccak (:158-179).  The JAX loop
// runs every row through all max_blocks permutations and masks the state;
// here each row stops at its own block count, which gives the same state.
//
// What bounds it on the card: integer operations.  One permutation is 24
// rounds of about 190 32-bit instructions (chi and theta's parity fold into
// three-input LOP3s, a 64-bit rotate is two funnel shifts) against 136
// bytes of block (272 as int64), about 17 instructions a byte moved, above
// the card's int32 rate-to-bandwidth ratio of about 5.  The
// design holds the 25 lanes of a row's state as native 64-bit registers
// (one thread per row), with theta, rho+pi, chi and iota fully unrolled
// over the lanes so every lane index and rotation is a compile-time
// constant, and the round constants in constant memory read with a
// uniform index.  A row touches device memory only to read its blocks and
// write its digest.
#include "limb_common.cuh"

namespace {

__constant__ uint64_t c_rc[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

constexpr int RATE_WORDS = 34;  // 136-byte rate block as 32-bit words
constexpr int RATE_LANES = 17;

// n in 1..63 (every rotation of the permutation)
__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

// keccak-f[1600] on lanes st[x + 5y]; rho+pi walks the lanes in place
// (lane PILN[i] takes the previous lane rotated by ROTC[i], from lane 1)
__device__ __forceinline__ void keccak_f(uint64_t st[25]) {
  const int rotc[24] = {1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
                        27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44};
  const int piln[24] = {10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
                        15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1};
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t bc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
#pragma unroll
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
      const int j = piln[i];
      const uint64_t next = st[j];
      st[j] = rotl64(t, rotc[i]);
      t = next;
    }
    // chi
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
      uint64_t b[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) b[i] = st[j + i];
#pragma unroll
      for (int i = 0; i < 5; ++i) st[j + i] = b[i] ^ (~b[(i + 1) % 5] & b[(i + 2) % 5]);
    }
    // iota
    st[0] ^= c_rc[round];
  }
}

__global__ void __launch_bounds__(THREADS_PER_BLOCK)
keccak_sponge_kernel(const int64_t* __restrict__ blocks, int max_blocks,
                     const int* __restrict__ n_blocks, int64_t* __restrict__ out, long long n) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  int nb = n_blocks[row];
  nb = nb < 0 ? 0 : (nb > max_blocks ? max_blocks : nb);
  const int64_t* src = blocks + row * (long long)max_blocks * RATE_WORDS;

  uint64_t st[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) st[i] = 0;
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    const int64_t* w = src + b * RATE_WORDS;
#pragma unroll
    for (int i = 0; i < RATE_LANES; ++i)
      st[i] ^= (uint64_t)(uint32_t)w[2 * i] | ((uint64_t)(uint32_t)w[2 * i + 1] << 32);
    keccak_f(st);
  }
  int64_t* o = out + row * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = (int64_t)(st[i] & 0xFFFFFFFFull);
    o[2 * i + 1] = (int64_t)(st[i] >> 32);
  }
}

}  // namespace

extern "C" int keccak_sponge_launch(const void* blocks, long long max_blocks, const void* n_blocks,
                                    void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (max_blocks < 1 || max_blocks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  keccak_sponge_kernel<<<grid_for(n), THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int64_t*)blocks, (int)max_blocks, (const int*)n_blocks, (int64_t*)out, n);
  return (int)cudaGetLastError();
}
