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
// What bounds it on the card depends on the batch.
//
// Many rows (a batch that fills the card, such as 65536 short preimages):
// integer operations.  One permutation is 24 rounds of about 190 32-bit
// instructions (chi and theta's parity fold into three-input LOP3s, a
// 64-bit rotate is two funnel shifts) against 136 bytes of block (272 as
// int64), about 17 instructions a byte moved, above the card's int32
// rate-to-bandwidth ratio of about 5.  The row kernel holds the 25 lanes of
// a row's state as native 64-bit registers (one thread per row), with
// theta, rho+pi, chi and iota fully unrolled over the lanes so every lane
// index and rotation is a compile-time constant.
//
// Few long rows (a block's keccak table: 1-8 bytecodes of 486 blocks): the
// chain.  A row's permutations depend on each other, so the least time is
// the longest row's blocks x 24 rounds x the round's least depth (5
// dependent instructions, runtime/bounds.py:keccak_round_chain).  One
// thread a row issues the round's 190
// instructions one after another (about 460 cycles a round), so the warp
// kernel spreads a row over the 32 threads of one warp: thread t < 25 owns
// lane t = x + 5y as a 64-bit register, threads 25-31 run along without a
// lane.  A round is two exchanges through the warp's shared memory:
//   theta: each thread stores its lane column-major (a column at
//          KECCAK_COL_PITCH lanes, so it is two 16-byte and one 8-byte
//          load), reads the columns x - 1 and x + 1 (c_theta_west,
//          c_theta_east; the warp's threads read 5 addresses of each, a
//          broadcast) and folds C[x-1] ^ rot(C[x+1], 1) into its lane;
//   rho:   its own lane rotated by its own offset (c_rho_rot), halves
//          swapped when the offset is 32 or more, then a funnel shift a
//          half, branchless (the offset differs from thread to thread);
//   pi+chi: it stores the rotated lane by lane index and reads the three
//          that pi brings to its lane and to the lanes x + 1 and x + 2 of
//          its row (c_pi_src, c_chi_src1, c_chi_src2), then one LOP3 a
//          half;
//   iota:  thread 0's lane takes the round constant (a mask zero elsewhere).
// A __syncwarp after each store orders it before the reads; the two
// exchanges use two buffers, so a round's stores never overwrite what the
// last round still reads.  Warp shuffles did the same exchanges in 26
// 32-bit shuffles a round, paced by the shuffles' issue, and ran slower at
// 8 rows x 486 blocks (PERF.md §6); a broadcast load of 8 or 16 bytes
// issues in a fraction of a shuffle's time.
// Threads 0-16 read the next block's 17 lanes (272 contiguous bytes, one
// 16-byte load each) while the current permutation runs; threads 0-3 write
// the digest.  Rows below KECCAK_COOP_ROWS take the warp kernel (the
// switch-over swept on the card at 1-486 blocks a row, PERF.md); the
// launcher counts the launches of each path.  Neither path synchronises
// the host or allocates, so both run inside a CUDA graph.
#include "limb_common.cuh"

#ifndef KECCAK_COOP_ROWS
#define KECCAK_COOP_ROWS 2560  // batches of fewer rows run one warp a row
#endif
#define KECCAK_COL_PITCH 6     // lanes a staged column takes (5, padded to 16-byte pairs)
#define KECCAK_COL_WORDS 40    // 5 columns and threads 25-31's slots

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

// The warp kernel's tables, one entry a thread t of a row's warp (t = x +
// 5y < 25 owns lane t; threads 25-31 read lane 0's columns and themselves):
// theta's west and east columns (x - 1 and x + 1 mod 5: lanes col + 5y'),
// rho's rotation of lane t, pi's source of lane t, and pi's sources of the
// lanes x + 1 and x + 2 of t's row (chi's operands).
__constant__ int c_theta_west[32] = {4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4,
                                     0, 1, 2, 3, 4, 0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 0};
__constant__ int c_theta_east[32] = {1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1,
                                     2, 3, 4, 0, 1, 2, 3, 4, 0, 0, 0, 0, 0, 0, 0, 0};
__constant__ int c_rho_rot[32] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41,
                                  45, 15, 21, 8, 18, 2, 61, 56, 14, 0, 0, 0, 0, 0, 0, 0};
__constant__ int c_pi_src[32] = {0, 6, 12, 18, 24, 3, 9, 10, 16, 22, 1, 7, 13, 19, 20, 4,
                                 5, 11, 17, 23, 2, 8, 14, 15, 21, 25, 26, 27, 28, 29, 30, 31};
__constant__ int c_chi_src1[32] = {6, 12, 18, 24, 0, 9, 10, 16, 22, 3, 7, 13, 19, 20, 1, 5,
                                   11, 17, 23, 4, 8, 14, 15, 21, 2, 25, 26, 27, 28, 29, 30, 31};
__constant__ int c_chi_src2[32] = {12, 18, 24, 0, 6, 10, 16, 22, 3, 9, 13, 19, 20, 1, 7, 11,
                                   17, 23, 4, 5, 14, 15, 21, 2, 8, 25, 26, 27, 28, 29, 30, 31};

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

__device__ __forceinline__ int clamp_blocks(const int* n_blocks, long long row, int max_blocks) {
  const int nb = n_blocks[row];
  return nb < 0 ? 0 : (nb > max_blocks ? max_blocks : nb);
}

// one thread a row
__global__ void __launch_bounds__(THREADS_PER_BLOCK)
keccak_sponge_kernel(const int64_t* __restrict__ blocks, int max_blocks,
                     const int* __restrict__ n_blocks, int64_t* __restrict__ out, long long n) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int nb = clamp_blocks(n_blocks, row, max_blocks);
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

// lane t's two words of rate block w (its 17 lanes; zero past them), one
// 16-byte load where the blocks are 16-byte aligned
__device__ __forceinline__ void block_lane(const int64_t* w, int t, int vec, uint32_t& lo,
                                           uint32_t& hi) {
  lo = hi = 0;
  if (t >= RATE_LANES) return;
  if (vec) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(w + 2 * t));
    lo = (uint32_t)v.x;
    hi = (uint32_t)v.y;
  } else {
    lo = (uint32_t)__ldg(reinterpret_cast<const long long*>(w + 2 * t));
    hi = (uint32_t)__ldg(reinterpret_cast<const long long*>(w + 2 * t + 1));
  }
}

// one warp a row, a block a row (see the head of the file)
__global__ void __launch_bounds__(32)
keccak_sponge_warp_kernel(const int64_t* __restrict__ blocks, int max_blocks,
                          const int* __restrict__ n_blocks, int64_t* __restrict__ out, int vec) {
  const int t = threadIdx.x;
  // the row read with threadIdx.x >> 5 (always 0), so the compiler cannot
  // prove it uniform: the round then measured 11 % faster than with
  // blockIdx.x alone (1.054 against 1.177 ms at 8 rows x 486 blocks,
  // PERF.md §6), likely because the block count and the block addresses
  // stay out of the uniform registers
  const long long row = (long long)blockIdx.x + (threadIdx.x >> 5);
  const int nb = clamp_blocks(n_blocks, row, max_blocks);
  const int64_t* src = blocks + row * (long long)max_blocks * RATE_WORDS;
  const int west = c_theta_west[t], east = c_theta_east[t];
  const int rot = c_rho_rot[t] & 31;
  const bool swap = c_rho_rot[t] >= 32;
  const int pi = c_pi_src[t], chi1 = c_chi_src1[t], chi2 = c_chi_src2[t];

  uint32_t lo = 0, hi = 0, next_lo = 0, next_hi = 0;
  if (nb > 0) block_lane(src, t, vec, next_lo, next_hi);
#pragma unroll 1
  for (int b = 0; b < nb; ++b) {
    lo ^= next_lo;
    hi ^= next_hi;
    if (b + 1 < nb) block_lane(src + (long long)(b + 1) * RATE_WORDS, t, vec, next_lo, next_hi);

    // the state column-major (lane x + 5y at KECCAK_COL_PITCH x + y;
    // threads 25-31 write past the columns), and the rotated lanes by lane
    __shared__ __align__(16) uint64_t cols[KECCAK_COL_WORDS];
    __shared__ uint64_t rho[32];
    const int at = t < 25 ? KECCAK_COL_PITCH * (t % 5) + t / 5 : 5 * KECCAK_COL_PITCH + t - 25;
    uint64_t st = (uint64_t)lo | ((uint64_t)hi << 32);
#pragma unroll 1
    for (int round = 0; round < 24; ++round) {
      // theta: the west and east columns, 16 + 16 + 8 bytes each
      cols[at] = st;
      __syncwarp();
      const ulonglong2 w01 = *reinterpret_cast<const ulonglong2*>(cols + KECCAK_COL_PITCH * west);
      const ulonglong2 w23 = *reinterpret_cast<const ulonglong2*>(cols + KECCAK_COL_PITCH * west + 2);
      const uint64_t w4 = cols[KECCAK_COL_PITCH * west + 4];
      const ulonglong2 e01 = *reinterpret_cast<const ulonglong2*>(cols + KECCAK_COL_PITCH * east);
      const ulonglong2 e23 = *reinterpret_cast<const ulonglong2*>(cols + KECCAK_COL_PITCH * east + 2);
      const uint64_t e4 = cols[KECCAK_COL_PITCH * east + 4];
      const uint64_t cw = w01.x ^ w01.y ^ w23.x ^ w23.y ^ w4;
      const uint64_t ce = e01.x ^ e01.y ^ e23.x ^ e23.y ^ e4;
      st ^= cw ^ ((ce << 1) | (ce >> 63));
      // rho on this lane: rotl64 by 32 + rot is rotl64 of the swapped
      // halves by rot, a funnel shift a half; pi and chi read three
      // rotated lanes
      const uint32_t l = (uint32_t)st, h = (uint32_t)(st >> 32);
      const uint32_t a = swap ? h : l;
      const uint32_t c = swap ? l : h;
      rho[t] = (uint64_t)__funnelshift_l(c, a, rot) | ((uint64_t)__funnelshift_l(a, c, rot) << 32);
      __syncwarp();
      const uint64_t b0 = rho[pi], b1 = rho[chi1], b2 = rho[chi2];
      // chi, then iota on lane 0
      st = b0 ^ (~b1 & b2) ^ (c_rc[round] & (uint64_t)(t == 0 ? ~0ull : 0ull));
    }
    lo = (uint32_t)st;
    hi = (uint32_t)(st >> 32);
  }
  if (t < 4) {
    int64_t* o = out + row * 8 + 2 * t;
    if (vec) {
      *reinterpret_cast<longlong2*>(o) = make_longlong2((int64_t)lo, (int64_t)hi);
    } else {
      o[0] = (int64_t)lo;
      o[1] = (int64_t)hi;
    }
  }
}

// launches per path since the library loaded: [row, warp]
long long g_path_launches[2] = {0, 0};

}  // namespace

extern "C" int keccak_sponge_launch(const void* blocks, long long max_blocks, const void* n_blocks,
                                    void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  if (max_blocks < 1 || max_blocks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n < KECCAK_COOP_ROWS) {
    // blocks rows are 272 x max_blocks bytes and out rows 64: the bases decide
    const int vec = ((uintptr_t)blocks & 15) == 0 && ((uintptr_t)out & 15) == 0;
    keccak_sponge_warp_kernel<<<(unsigned)n, 32, 0, s>>>(
        (const int64_t*)blocks, (int)max_blocks, (const int*)n_blocks, (int64_t*)out, vec);
    ++g_path_launches[1];
  } else {
    keccak_sponge_kernel<<<grid_for(n), THREADS_PER_BLOCK, 0, s>>>(
        (const int64_t*)blocks, (int)max_blocks, (const int*)n_blocks, (int64_t*)out, n);
    ++g_path_launches[0];
  }
  return (int)cudaGetLastError();
}

// the launches of each path since the library loaded
extern "C" int keccak_sponge_path_launches(void* row, void* warp) {
  *(long long*)row = g_path_launches[0];
  *(long long*)warp = g_path_launches[1];
  return 0;
}
